"""Share of the simulator's traced window in which no kernel or copy ran
on the device."""


def read(ctx):
    win = ctx["window"]
    if not win.device:
        return None
    return 100.0 * (1.0 - win.busy_s / win.window_s)
