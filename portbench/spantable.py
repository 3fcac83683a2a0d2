"""The program's span table (``repro_torch.obs.spans``) as the span metrics
read it: its raw records, cut to the traced window, and their self time.

A record is (name, start ns, end ns, parent index or -1, counts).  Spans
record only while a profiler runs, and a driver profiles its window alone,
so the window is the table's tail: from the ``n``-th last root span of the
window's own kind (``sim.run`` a call, ``train.step`` a step) on.  The
arithmetic is the benchmark's own, so that a later change to the program
cannot move it.  Every reader returns None where the program keeps no
table (a tree without spans), where the cap dropped records, or where the
table holds fewer such roots than the window.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Record = Tuple[str, int, int, int, dict]


def window(root: str, n: int) -> Optional[List[Tuple[int, Record]]]:
    """(index, record) of the table's records from the ``n``-th last root
    span named ``root`` to the end, or None."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    recs = spans.records()
    if n <= 0 or spans.dropped() or any(r is None for r in recs):
        return None
    roots = [i for i, (name, _, _, parent, _) in enumerate(recs)
             if parent == -1 and name == root]
    if len(roots) < n:
        return None
    first = roots[-n]
    return [(i, tuple(recs[i])) for i in range(first, len(recs))]


def seconds(win: List[Tuple[int, Record]], names: Sequence[str],
            own: bool) -> float:
    """Host seconds of the records named in ``names``: their durations, or
    with ``own`` their self time, each one's duration less the part of it
    that its children's spans cover."""
    kids = {}
    for _, (_, s, e, parent, _) in win:
        kids.setdefault(parent, []).append((s, e))
    total = 0
    for i, (name, s, e, _, _) in win:
        if name not in names:
            continue
        total += e - s
        if own:
            last = s
            for cs, ce in sorted(kids.get(i, ())):
                cs, ce = max(cs, last), min(ce, e)
                if ce > cs:
                    total -= ce - cs
                    last = ce
    return total / 1e9
