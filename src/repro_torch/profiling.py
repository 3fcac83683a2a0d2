"""Summaries of a ``torch.profiler`` window, shared by the port's profilers
(``xp/profile_path.py`` for the trainer, ``launch/profile_serve.py`` for
the serve path)."""
from __future__ import annotations


def device_busy_ms(prof) -> float:
    """Device time covered by at least one kernel or copy (union of spans)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA" and e.time_range.end > 0)
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
