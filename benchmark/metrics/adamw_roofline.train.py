"""adamw_roofline.train: the whole optimizer step's share of its roofline
(``AdamWLowmem.step``: the fused kernel K8 and its elementwise tail): the
least time of reading each gradient, reading and writing each parameter
and both moments, for every parameter group (the yardstick's count), over
the step's device time, from CUDA events that the harness records around
each optimizer step (the untraced rest of a traced run's window)."""

from harness.yardstick import adamw_work, least_seconds


def read(ctx):
    ms = ctx.get("adamw_ms") or []
    if not ms:
        return None
    least = least_seconds(*adamw_work(ctx["adamw_groups"]), ctx["peak_flops"])
    return 100.0 * least * len(ms) / (sum(ms) / 1e3)
