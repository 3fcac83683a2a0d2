"""Structured JSONL run logging.

The port's copy of the reference's ``repro/obs/runlog.py``.

:class:`RunLogger` replaces bare ``warnings.warn`` / stderr prints with a
machine-readable event stream: one JSON object per line, each carrying an
``event`` tag plus free-form fields.  The trainer always owns a logger;
with no path it is a cheap no-op (a single attribute check per call), so
the hot dispatch loops can log unconditionally.

Events the trainer emits (the log schema, also documented in README):

``run_start``      n, mode, algorithm-ish metadata the caller passes
``block_dispatch`` mode, events, rounds — one per dispatched block
``bucket_segment`` bucket (lane width), events, offset — bucketed path
``compile``        key — first-time set-up of a mode's update path
``pool_wrap``      the batch-pool reuse warning (also a ``warnings.warn``)
``rng_order``      horizon-batcher RNG-order notice (log-only)
``sanitize``       the runtime sanitizer is on for this run
``staleness_bound`` DSGD-AAU runtime monitor result (ok / exceeded)
``run_end``        rounds, t, comm — final totals

Every record additionally carries ``ts`` — wall-clock seconds since the
logger was constructed (monotonic clock) — which is what lets
``python -m repro_torch.obs.trace`` rebuild a wall-time Perfetto track
(per-block dispatch spans, per-rung segment spans, compile instants)
from the log alone.

``warn_once(key, message, warn=True)`` dedupes by key for the logger's
lifetime and forwards to :func:`warnings.warn` (stacklevel raised so the
caller's caller is blamed) — keeping the stderr contract tests rely on
while the JSONL file gets the structured copy.
"""
from __future__ import annotations

import json
import time
import warnings
from typing import IO, Optional, Set, Union


class RunLogger:
    """Append-only JSONL event log; no-op when constructed without a path."""

    def __init__(self, path: Optional[Union[str, IO[str]]] = None):
        self._fh: Optional[IO[str]] = None
        self._own = False
        if path is None:
            pass
        elif hasattr(path, "write"):
            self._fh = path                      # caller-owned stream
        else:
            self._fh = open(path, "a", encoding="utf-8")
            self._own = True
        self._seen: Set[str] = set()
        self._t0 = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"event": event,
               "ts": round(time.monotonic() - self._t0, 6)}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def warn_once(self, key: str, message: str, warn: bool = True) -> None:
        """Emit ``message`` at most once per run.

        Always recorded in the JSONL log (when enabled); additionally sent
        through :func:`warnings.warn` unless ``warn=False`` (notices that
        predate no stderr contract stay log-only).
        """
        if key in self._seen:
            return
        self._seen.add(key)
        self.log(key, message=message)
        if warn:
            warnings.warn(message, stacklevel=3)

    def close(self) -> None:
        if self._fh is not None and self._own:
            self._fh.close()
        self._fh = None
