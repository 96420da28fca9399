"""moe_fwd_ms.train: device milliseconds a step of every ``MoEMLP``
forward, from CUDA events that the harness's forward hooks record around
each expert layer (the untraced rest of a traced run's window), averaged over the window's steps."""


def read(ctx):
    ms = ctx.get("moe_fwd_ms") or []
    return sum(ms) / len(ms) if ms else None
