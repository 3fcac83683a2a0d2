"""Device kernels and copies of the training step's traced window per
step."""


def read(ctx):
    if not ctx.get("steps") or not ctx["window"].device:
        return None
    return len(ctx["window"].device) / ctx["steps"]
