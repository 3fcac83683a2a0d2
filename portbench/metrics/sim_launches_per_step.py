"""Device kernels and copies of the simulator's traced window per worker
step (a DSGD-AAU event counts one, a synchronous round N)."""


def read(ctx):
    if not ctx.get("worker_steps") or not ctx["window"].device:
        return None
    return len(ctx["window"].device) / ctx["worker_steps"]
