"""batch_occupancy.serve: the scheduler's mean number of active slots at a
decode step, over the cache's slots (the harness's span around each
``ServeEngine.decode`` call, traced run)."""


def read(ctx):
    steps = ctx["spans"]["decode"]
    if not steps:
        return None
    return 100.0 * sum(a for _, a in steps) / len(steps) / ctx["slots"]
