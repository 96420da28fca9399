"""paged_decode_roofline.serve: the paged decode kernel's (K7) share of
its roofline in the decode steps of the traced window: the least time of
reading each active slot's keys and values up to its length, its query
and writing its output, every layer (the yardstick's count), over K7's
device time."""

from harness.trace import kernel_seconds
from harness.yardstick import least_seconds, paged_decode_work


def read(ctx):
    tr, steps = ctx.get("trace"), ctx["work"]["decode"]
    if not tr or not steps:
        return None
    device = kernel_seconds(tr, "paged_decode_kernel")
    if device <= 0:
        return None
    c = ctx["config"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd, L = c["hidden_size"] // H, c["num_hidden_layers"]
    least = sum(least_seconds(*paged_decode_work(att, n, H, KV, hd, L), ctx["peak_flops"])
                for att, n in steps)
    return 100.0 * least / device
