"""serve_mfu: the model's share of the card's bf16 peak while serving: the
forward FLOPs of the prompt and output tokens served in the window (every
projection and the head, attention over the positions each token sees;
the yardstick's count, no padding) over the window, over the peak (in a
traced run, over the untraced rest of the window)."""


def read(ctx):
    if not ctx.get("served_flops"):
        return None
    return 100.0 * ctx["served_flops"] / ctx["rest_s"] / ctx["peak_flops"]
