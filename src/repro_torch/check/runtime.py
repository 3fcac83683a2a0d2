"""Runtime sanitizer: no implicit device→host transfer inside a run.

The port's twin of the reference's ``repro/check/runtime.py``.  A trainer
run is meant to queue device work and never wait for it, except at its
explicit fetches (the eval history, the telemetry drain, the fused trace
drain, the pool-wrap check).  :func:`sanitized` turns that contract into
errors:

- On every device, :func:`host_conversion_guard` patches the tensor
  conversion surface (``.item()``, ``.tolist()``, ``.numpy()``,
  ``float()``, ``int()``, ``bool()``, ``__index__``, ``__array__``) so a
  call outside :func:`fetch` raises.  On the CPU nothing transfers, but
  the same call would block the card's queue, so the guard holds the CPU
  run to the card's contract (the reference's ``host_conversion_guard``).
- On CUDA, ``torch.cuda.set_sync_debug_mode("error")`` also raises on the
  synchronizing calls that pass no Python conversion (a blocking copy, a
  ``nonzero``, a boolean-mask index).  The mode also flags a *blocking*
  host→device copy; the port makes every host→device copy of a run with
  ``non_blocking=True`` from pageable memory, which CUDA stages without a
  device synchronisation and PyTorch does not flag, so only device→host
  synchronisation is refused.

:func:`fetch` is the one sanctioned device→host transfer: it packs its
tensors into one float64 buffer on the device, copies that once, and
counts the fetch (:class:`SanitizerStats`).

The reference's ``CompileCounter`` / ``jit_cache_size`` half reads XLA's
jit caches; PyTorch runs eagerly and compiles nothing per block shape, so
it has no counterpart here.

The trainer enables :func:`sanitized` around its driving loop when
constructed with ``sanitize=True`` or when ``REPRO_SANITIZE=1`` is set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterator, Optional

import numpy as np
import torch

_FALSEY = ("", "0", "false", "no", "off")

# The conversions through which a tensor reaches the host from Python.
_CONVERSIONS = ("item", "tolist", "numpy", "__array__", "__float__",
                "__int__", "__bool__", "__index__", "__complex__")


def sanitize_enabled(env: Optional[str] = None) -> bool:
    """True when the ``REPRO_SANITIZE`` flag asks for sanitized runs."""
    val = os.environ.get("REPRO_SANITIZE", "") if env is None else env
    return val.strip().lower() not in _FALSEY


@dataclasses.dataclass
class SanitizerStats:
    """What one guarded region saw: its explicit fetches."""

    fetches: int = 0


class _GuardState:
    """Shared state of the (re-entrant) conversion guard."""

    def __init__(self) -> None:
        self.depth = 0          # guard nesting
        self.explicit = 0       # inside fetch()
        self.stats: Optional[SanitizerStats] = None


_state = _GuardState()


def fetch(*tensors: torch.Tensor):
    """Copy ``tensors`` to the host as NumPy arrays in ONE transfer.

    Several tensors are cast to float64 and concatenated on the device,
    copied once and split again on the host, each cast back to its dtype
    (bfloat16 comes back as float32; integers must stay below 2**53, which
    counters, indices and event counts do).  Returns one array for one
    tensor, else a tuple.  Legal inside :func:`sanitized`, where it is
    counted.
    """
    _state.explicit += 1
    try:
        if _state.stats is not None:
            _state.stats.fetches += 1
        with _sync_allowed():
            if len(tensors) == 1:
                return _to_numpy(tensors[0].cpu())
            flat = torch.cat([t.reshape(-1).to(torch.float64)
                              for t in tensors]).cpu().numpy()
        out, at = [], 0
        for t in tensors:
            part = flat[at:at + t.numel()].reshape(tuple(t.shape))
            at += t.numel()
            out.append(part.astype(_numpy_dtype(t.dtype)))
        return tuple(out)
    finally:
        _state.explicit -= 1


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


@contextlib.contextmanager
def _sync_allowed() -> Iterator[None]:
    """Lift CUDA's sync debug mode for one explicit fetch."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def host_conversion_guard() -> Iterator[SanitizerStats]:
    """Reject implicit tensor→host conversions; :func:`fetch` passes.

    Patches ``torch.Tensor``'s conversion surface for the region, where a
    conversion outside :func:`fetch` raises ``RuntimeError``, and yields
    the region's :class:`SanitizerStats`.
    """
    cls = torch.Tensor
    own = {name: cls.__dict__.get(name) for name in _CONVERSIONS}
    inherited = {name: getattr(cls, name) for name in _CONVERSIONS}

    def _wrap(name: str, orig: Any) -> Any:
        def guarded(self, *args: Any, **kwargs: Any) -> Any:
            if _state.depth > 0 and _state.explicit == 0:
                raise RuntimeError(
                    f"implicit device→host conversion `{name}` on a tensor "
                    f"of shape {tuple(self.shape)} inside a sanitized run; "
                    "fetch explicitly with "
                    "repro_torch.check.runtime.fetch(...)")
            return orig(self, *args, **kwargs)

        return guarded

    first = _state.depth == 0
    if first:
        _state.stats = SanitizerStats()
        for name, orig in inherited.items():
            setattr(cls, name, _wrap(name, orig))
    stats = _state.stats
    _state.depth += 1
    try:
        yield stats
    finally:
        _state.depth -= 1
        if first:
            for name, orig in own.items():
                if orig is None:
                    delattr(cls, name)
                else:
                    setattr(cls, name, orig)
            _state.stats = None


@contextlib.contextmanager
def sanitized(device: Optional[torch.device] = None
              ) -> Iterator[SanitizerStats]:
    """The runtime sanitizer for one run on ``device``.

    Stacks :func:`host_conversion_guard` and, for a CUDA device,
    ``torch.cuda.set_sync_debug_mode("error")`` (restored after).  Yields
    the region's :class:`SanitizerStats`.
    """
    with contextlib.ExitStack() as stack:
        stats = stack.enter_context(host_conversion_guard())
        if device is not None and torch.device(device).type == "cuda":
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            stack.callback(torch.cuda.set_sync_debug_mode, mode)
        yield stats
