"""flash_roofline.train: the attention kernels' share of their roofline in
the traced steps: the least time of causal attention's forward and
backward at the cell's shapes (the yardstick's counts, each layer of each
step) over the device time of the forward kernel (K1) and the backward's
dQ and dK/dV kernels."""

from harness.trace import kernel_seconds
from harness.yardstick import flash_bwd_work, flash_fwd_work, least_seconds


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("traced_steps"):
        return None
    device = kernel_seconds(tr, "flash_fwd_kernel", "dq::kernel", "dkv::kernel")
    if device <= 0:
        return None
    c, t = ctx["config"], ctx["traffic"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // H
    shape = (t["seq_len"], H, KV, hd, t["batch"])
    least = sum(least_seconds(*w(*shape), ctx["peak_flops"]) for w in (flash_fwd_work, flash_bwd_work))
    return 100.0 * least * c["num_hidden_layers"] * ctx["traced_steps"] / device
