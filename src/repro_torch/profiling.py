"""Timing and ``torch.profiler`` summaries shared by the port's measuring
scripts: ``chip_smoke.py`` phase 2 and ``xp/kernel_times.py`` time kernels
with :func:`time_ms`, :func:`device_ms` and :func:`host_us`;
``xp/profile_path.py`` (the trainer) and ``launch/profile_serve.py`` (the
serve path) summarise a profiled window with :func:`window_summary`."""
from __future__ import annotations

import time
from collections import Counter


def device_events(prof) -> list:
    """The device's kernels and copies recorded in a profiled window."""
    return [e for e in prof.events()
            if e.device_type.name == "CUDA" and e.time_range.end > 0]


def busy_ms(events) -> float:
    """Device time covered by at least one of ``events`` (union of spans)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def device_busy_ms(prof) -> float:
    """Device time covered by at least one kernel or copy of the window."""
    return busy_ms(device_events(prof))


def window_summary(prof, wall_s: float, top: int) -> dict:
    """Host-clock ms of the window, the device's busy ms and idle share in
    it, and the ``top`` operators by device time and by host time as
    (name, calls, ms)."""
    busy = device_busy_ms(prof)
    ka = prof.key_averages()
    dev_rows = sorted(ka, key=lambda e: -e.self_device_time_total)[:top]
    host_rows = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:top]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall_s * 1e3),
            "top_device_ms": [(e.key, e.count, e.self_device_time_total / 1e3)
                              for e in dev_rows],
            "top_host_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                            for e in host_rows]}


# -- timing of one call -------------------------------------------------------

def _warm(fn) -> None:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call: the larger
    of the device time and the host's issue time of a call, with whatever
    of its operands the previous call left in L2."""
    import torch
    _warm(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host time per call, issue only: the host clock around ``reps``
    calls with no synchronise inside (fewer launches than the card's
    queue holds, so the host never waits for the device)."""
    import torch
    _warm(fn)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


FLUSH_BYTES = 256 * 2**20   # five times the H100's 50 MB L2
TRIES = 5                   # profiled windows before device_ms gives up
LEAD = 2                    # flushes that open a window (see device_ms)


def l2_flush(device):
    """A call that empties the card's L2 (50 MB on the H100) of everything
    else and leaves it clean: it reads ``FLUSH_BYTES`` and writes 1/256 of
    that.  One kernel: row sums of 256 floats need no cross-block pass,
    which a whole sum takes with a memset, a name cuBLAS launches too."""
    import torch
    buf = torch.ones(FLUSH_BYTES // 1024, 256, device=device)
    return lambda: buf.sum(1)


def _profiled(calls, reps: int, lead=()) -> list:
    """The device events of ``reps`` rounds of ``calls``, after one call of
    each of ``lead``, in one profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in lead:
            call()
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    return device_events(prof)


def whole_window(names, reps: int, launches: int | None = None,
                 flush_counts: Counter | None = None, lead: int = 0) -> bool:
    """Whether the device events named ``names``, recorded over ``reps``
    calls (each after one flush that alone launches ``flush_counts``, the
    window opened by ``lead`` more flushes), hold every event of the timed
    calls: each name other than the flush's a whole number of times per
    call, ``launches`` of them per call in all where given, and the
    flush's names no more often than the flushes launch them -- more means
    the timed call launches one of them too.  A flush event may be
    missing: its time is not counted, and the profiler has dropped the
    first events of a window on the H100."""
    flush_counts = flush_counts or Counter()
    counts = Counter(names)
    mine = {k: c for k, c in counts.items() if k not in flush_counts}
    n = sum(mine.values())
    return (n > 0 and all(c % reps == 0 for c in mine.values())
            and all(counts[k] <= c * (reps + lead)
                    for k, c in flush_counts.items())
            and (launches is None or n == launches * reps))


def flush_counts(flush, reps: int) -> Counter:
    """The device events one call of ``flush`` launches, by name: learnt
    from a profiled window of ``reps`` calls (a window of one call has come
    back empty on the H100) and kept on ``flush`` for later calls."""
    counts = getattr(flush, "counts", None)
    if counts is not None:
        return counts
    _warm(flush)
    seen = Counter()
    for _ in range(TRIES):
        seen = Counter(e.name for e in _profiled([flush], reps))
        if seen and all(c % reps == 0 for c in seen.values()):
            flush.counts = Counter({k: c // reps for k, c in seen.items()})
            return flush.counts
    raise RuntimeError(f"device_ms: {TRIES} profiled windows of {reps} "
                       f"flushes recorded device events {dict(seen)}, not a "
                       "whole number per call")


def device_ms(fn, reps: int, launches: int | None = None,
              flush=None) -> float:
    """Device time per call: the time covered by ``fn``'s kernels and
    copies in a profiled run of ``reps`` calls, over ``reps``; free of the
    host's issue time, which :func:`time_ms` measures whenever a call is
    issued slower than the card runs it.

    With ``flush`` (see :func:`l2_flush`), each call follows a flush and
    the flush's own events are left out, so every call reads its operands
    from device memory, as a bound by bytes counts them.

    The window is held to its count of events (:func:`whole_window`).  The
    profiler has handed back windows with device events missing (on the
    H100, windows of a few ms of microsecond kernels, all their events or
    the first one or two), so with ``flush`` the window opens with
    ``LEAD`` flushes whose events may go missing unseen, and a window
    that fails the count is profiled again, up to ``TRIES`` times in all;
    then this raises."""
    per_flush = flush_counts(flush, reps) if flush is not None else Counter()
    _warm(fn)
    calls = [flush, fn] if flush is not None else [fn]
    lead = (flush,) * LEAD if flush is not None else ()
    names = []
    for _ in range(TRIES):
        events = _profiled(calls, reps, lead)
        names = [e.name for e in events]
        if whole_window(names, reps, launches, per_flush, len(lead)):
            return busy_ms([e for e in events
                            if e.name not in per_flush]) / reps
    raise RuntimeError(
        f"device_ms: {TRIES} profiled windows of {reps} calls recorded "
        f"device events {dict(Counter(names))}, not "
        + (f"{launches} per call" if launches is not None
           else "a whole number per call")
        + (f" beside the flush's {dict(per_flush)} per call"
           if per_flush else ""))
