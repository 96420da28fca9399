"""train_mfu: the whole training step's share of the card's bf16 peak, by
the port bench's formula (``6 * active + 12 * L * T * d`` FLOPs a token,
the yardstick's frozen copy) over the window's tokens a second."""

from harness.yardstick import mixtral_train_flops_per_token


def read(ctx):
    if not ctx.get("tokens_per_s"):
        return None
    c, t = ctx["config"], ctx["traffic"]
    return 100.0 * ctx["tokens_per_s"] * mixtral_train_flops_per_token(c, t["seq_len"]) / ctx["peak_flops"]
