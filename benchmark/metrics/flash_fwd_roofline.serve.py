"""flash_fwd_roofline.serve: the flash forward kernel's (K1) share of its
roofline in the prefills of the traced window: the least time of causal
attention over each prompt's real length, every layer (the yardstick's
count, no padding), over K1's device time."""

from harness.trace import kernel_seconds
from harness.yardstick import flash_fwd_work, least_seconds


def read(ctx):
    tr, lens = ctx.get("trace"), ctx["work"]["prefill"]
    if not tr or not lens:
        return None
    device = kernel_seconds(tr, "flash_fwd_kernel")
    if device <= 0:
        return None
    c = ctx["config"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // H
    least = sum(least_seconds(*flash_fwd_work(n, H, KV, hd), ctx["peak_flops"]) for n in lens)
    return 100.0 * least * c["num_hidden_layers"] / device
