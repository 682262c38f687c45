"""upload_bytes_per_sample.sharded (layer: parallel/mesh._to (host to
card)): the bytes the program placed from host memory on the card over
the traced passes (its `parallel.mesh.upload_bytes` count) over the
capture samples of those passes (every file's samples), in bytes. 8 is
complex64; a program that keeps no such count reads nothing."""


def read(ctx):
    c = ctx["counters"]
    if c.get("upload_bytes") is None or not c.get("samples"):
        return None
    return c["upload_bytes"] / c["samples"]
