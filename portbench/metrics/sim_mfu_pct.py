"""Model FLOPs of the simulated workers' gradients in the traced window,
over the device's busy time in it (``yardstick.Window.busy_s``), against
the card's float32 peak: each worker that took a gradient in an event
(``active_sum``) trained on its batch's tokens, 6 FLOPs a product
parameter a token plus causal attention (``yardstick.train_flops``);
padded lanes and the evaluations are not counted.  The profiler slows
the host, which the busy time leaves out; the idle share
(``sim_device_idle_pct``) gives the wall clock's part."""
from portbench.yardstick import PEAK_FLOPS, train_flops


def read(ctx):
    win = ctx["window"]
    if not ctx.get("active_sum") or not win.device:
        return None
    data = ctx["traffic"]["data"]
    tokens = ctx["active_sum"] * data["batch"] * data["seq_len"]
    flops = train_flops(ctx["config"], data["seq_len"], tokens)
    peak = PEAK_FLOPS[ctx["config"]["torch_dtype"]]
    return 100.0 * flops / (win.busy_s * peak)
