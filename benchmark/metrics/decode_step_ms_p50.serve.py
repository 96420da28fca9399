"""decode_step_ms_p50.serve: the median wall time of ``ServeEngine.decode``
(one step of every slot), from the harness's span around each call, which
ends in a synchronise (the untraced rest of a traced run's window)."""

import statistics


def read(ctx):
    s = ctx["spans"]["decode"]
    return statistics.median(d for d, _ in s) * 1e3 if s else None
