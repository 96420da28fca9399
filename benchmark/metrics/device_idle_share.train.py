"""device_idle_share: the share of the traced window in which no
operation ran on the card (the profiler's device records, merged)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
