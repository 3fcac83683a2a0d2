"""Host seconds a training step spends issuing the workers' gradients: the
durations of the program's ``train.forward`` (``lm_loss``) and
``train.backward`` (``torch.autograd.grad``) spans over the traced
window's steps, read from the program's span table."""
from portbench import spantable


def read(ctx):
    steps = ctx.get("steps") or 0
    win = spantable.window("train.step", steps)
    if not win:
        return None
    return spantable.seconds(win, ("train.forward", "train.backward"),
                             own=False) / steps
