"""The device's peak of allocated memory over the traced window, GiB
(``torch.cuda.max_memory_allocated`` after the set-up's peak is reset)."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
