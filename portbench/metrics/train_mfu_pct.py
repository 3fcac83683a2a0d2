"""Model FLOPs of the training steps of the traced window (every worker's
forward and backward, recomputation not counted, ``yardstick.train_flops``)
over the device's busy time in it (``yardstick.Window.busy_s``), against
the card's peak in the configuration's dtype.  The profiler slows
the host, which the busy time leaves out; the idle share
(``train_device_idle_pct``) gives the wall clock's part."""
from portbench.yardstick import PEAK_FLOPS, train_flops


def read(ctx):
    win = ctx["window"]
    if not ctx.get("tokens") or not win.device:
        return None
    flops = train_flops(ctx["config"], ctx["traffic"]["seq_len"], ctx["tokens"])
    peak = PEAK_FLOPS[ctx["config"]["torch_dtype"]]
    return 100.0 * flops / (win.busy_s * peak)
