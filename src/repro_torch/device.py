"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda", *,
                   shapes_only: bool = False) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``cuda`` is the default everywhere; it is never silently replaced by
    the CPU.  A machine without a usable CUDA device raises here, and the
    caller opts into the CPU with ``device="cpu"`` (the tests do).
    ``meta`` passes only with ``shapes_only``, which the constructors that
    compute nothing set (``init_model`` without a generator,
    ``init_decode_state``, ``launch.steps.stacked_init``): abstract inputs
    for the dry run, never a device to compute on.
    """
    dev = torch.device(device)
    if dev.type == "meta" and shapes_only:
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
