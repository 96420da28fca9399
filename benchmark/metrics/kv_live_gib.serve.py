"""kv_live_gib.serve: the most K/V the requests in flight held at once,
in GiB: the positions of the active slots (prompt and tokens so far, with
the one being decoded) at a decode call of the traced run, times K and V
of a position in every layer.  Beside ``peak_mem_gib.serve`` it shows how
much of the cache's reserved pool the traffic fills."""


def read(ctx):
    live = ctx.get("kv_live_bytes")
    return live / 2 ** 30 if live else None
