"""peak_mem_gib: the most device memory the run's tensors held
(``torch.cuda.max_memory_allocated`` at the window's close), in GiB."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
