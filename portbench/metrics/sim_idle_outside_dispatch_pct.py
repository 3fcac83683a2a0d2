"""The simulator's device idle time that the trainer's own host work leaves
outside dispatch: the parts of the gaps between consecutive device spans
(the union of the traced window's kernels and copies, the gaps
``yardstick.Window.breakdown`` lists) that no ``sim.dispatch`` range of
the program's host trace covers, over the window's host-clock seconds.
Event generation, packing, evaluation and the history's fetch leave it;
the launches' own host cost inside dispatch does not."""


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint spans."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    win = ctx["window"]
    dispatch = _union([(s, e) for n, s, e in win.host if n == "sim.dispatch"])
    if not win.device or not dispatch:
        return None
    busy = _union([(s, e) for _, s, e in win.device])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle_us = sum(e - s for s, e in gaps) - _overlap(gaps, dispatch)
    return 100.0 * idle_us / 1e6 / win.window_s
