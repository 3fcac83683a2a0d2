"""The port's timing helpers (``repro_torch/profiling.py``) on recorded
events: the union of device spans, and the count that a profiled window of
kernel calls must show before its time is taken.  No device is needed: the
events are stand-ins with the profiler's ``name`` and ``time_range``."""
from collections import Counter
from types import SimpleNamespace

import pytest

from repro_torch import profiling


def _ev(name, start, end):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("spans,ms", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (500, 1500)], 1.5),            # overlap counted once
    ([(2000, 2500), (0, 1000)], 1.5),           # order does not matter
    ([(0, 3000), (1000, 2000)], 3.0),           # nested
    ([(0, 1000), (1000, 2000), (5000, 5500)], 2.5),
])
def test_busy_ms_is_the_union_of_spans(spans, ms):
    assert profiling.busy_ms([_ev("k", s, e) for s, e in spans]) == \
        pytest.approx(ms)


FLUSH = Counter({"reduce": 1, "memset": 1})


@pytest.mark.parametrize("names,launches,flush,ok", [
    # two kernels a call (split prepass and product), three calls
    (["split", "mix"] * 3, 2, None, True),
    (["split", "mix"] * 3, None, None, True),
    (["split", "mix"] * 3 + ["split"], 2, None, False),   # a stray event
    (["split", "mix", "split", "mix", "mix"], 2, None, False),  # one dropped
    (["split", "mix"] * 3, 1, None, False),               # not the launches
    ([], None, None, False),                              # nothing recorded
    # each call after a flush, whose events are left out of the count
    (["reduce", "memset", "copy"] * 3, 1, FLUSH, True),
    (["reduce", "memset", "copy"] * 3, None, FLUSH, True),
    (["reduce", "memset"] * 3 + ["copy"] * 2, 1, FLUSH, False),
    # a flush event missing: its time is not counted anyway
    (["reduce", "copy"] * 3 + ["memset"] * 2, 1, FLUSH, True),
    # the call launches a kernel of the flush's name: its count is off
    (["reduce", "memset", "reduce", "copy"] * 3, 1, FLUSH, False),
    (["reduce", "memset"] * 3, None, FLUSH, False),       # only the flush
])
def test_whole_window_needs_every_event_of_every_call(names, launches, flush,
                                                      ok):
    assert profiling.whole_window(names, 3, launches, flush) is ok


class _Card:
    """Stand-in for profiled windows: each window records the ``events``
    (name, duration in us) of every call of the flush and the timed
    function, one after another 10 us apart, less the first events that
    the next entry of ``drops`` removes (``"all"``: every event)."""

    def __init__(self, monkeypatch, drops=()):
        self.drops = list(drops)
        self.windows = 0
        monkeypatch.setattr(profiling, "_warm", lambda fn: None)
        monkeypatch.setattr(profiling, "_profiled", self.profiled)

    def profiled(self, calls, reps, lead=()):
        self.windows += 1
        events, t = [], 0
        for call in list(lead) + [c for _ in range(reps) for c in calls]:
            for name, dur in call.events:
                events.append(_ev(name, t, t + dur))
                t += dur + 10
        drop = self.drops.pop(0) if self.drops else 0
        return [] if drop == "all" else events[drop:]


def _call(*events):
    fn = lambda: None  # noqa: E731
    fn.events = events
    return fn


def test_device_ms_leaves_the_flush_out(monkeypatch):
    card = _Card(monkeypatch)
    flush = _call(("reduce", 5000))
    fn = _call(("split", 1000), ("mix", 3000))
    # spans in us: 1 + 3 ms a call, the gaps between kernels not counted
    assert profiling.device_ms(fn, 4, launches=2, flush=flush) == \
        pytest.approx(4.0)
    assert flush.counts == Counter({"reduce": 1})
    assert card.windows == 2          # the flush's names learnt once


@pytest.mark.parametrize("drops,windows", [
    (["all"], 2),                     # a window with no device event
    ([1], 2),                         # one event missing
    ([1, "all", 1, 1], 5),            # refused four times, then whole
])
def test_device_ms_profiles_a_short_window_again(monkeypatch, drops, windows):
    card = _Card(monkeypatch, drops)
    fn = _call(("scatter", 2000))
    assert profiling.device_ms(fn, 3, launches=1) == pytest.approx(2.0)
    assert card.windows == windows


def test_device_ms_takes_a_window_that_lost_a_flush_event(monkeypatch):
    card = _Card(monkeypatch, [0, 1])  # the timed window's first event
    flush = _call(("reduce", 5000))
    fn = _call(("scatter", 2000))
    assert profiling.device_ms(fn, 3, launches=1, flush=flush) == \
        pytest.approx(2.0)
    assert card.windows == 2


def test_device_ms_takes_a_window_that_lost_its_first_two_events(monkeypatch):
    """The first two events of a timed window gone (the flush's and the
    timed call's first kernel, as the H100's profiler has returned them):
    the window's two opening flushes absorb them."""
    card = _Card(monkeypatch, [0, 2])
    flush = _call(("reduce", 5000))
    fn = _call(("cast", 500), ("gemm", 3000))
    assert profiling.device_ms(fn, 3, launches=2, flush=flush) == \
        pytest.approx(3.5)
    assert card.windows == 2


def test_device_ms_raises_when_no_window_is_whole(monkeypatch):
    _Card(monkeypatch, [1] * 5)
    with pytest.raises(RuntimeError, match="1 per call"):
        profiling.device_ms(_call(("scatter", 2000)), 3, launches=1)


def test_device_ms_refuses_a_call_that_shares_the_flush_names(monkeypatch):
    _Card(monkeypatch)
    flush = _call(("memset", 100), ("reduce", 5000))
    fn = _call(("memset", 100), ("gemm", 3000))
    with pytest.raises(RuntimeError, match="beside the flush"):
        profiling.device_ms(fn, 3, flush=flush)
