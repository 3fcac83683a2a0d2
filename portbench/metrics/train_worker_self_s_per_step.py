"""Host seconds a training step spends in the workers' bodies outside the
forward, the backward and SGD: the self time of the program's
``train.worker`` spans (each one's duration less what its
``train.forward``, ``train.backward`` and ``train.sgd`` spans cover) over
the traced window's steps, read from the program's span table."""
from portbench import spantable


def read(ctx):
    steps = ctx.get("steps") or 0
    win = spantable.window("train.step", steps)
    if not win:
        return None
    return spantable.seconds(win, ("train.worker",), own=True) / steps
