"""Wrapper of the linear_scan CUDA kernel: the RG-LRU's diagonal recurrence.

``linear_scan`` computes h_t = a_t ⊙ h_{t-1} + x_t, h_0 = 0, over axis 1 of
(B, T, W) operands: it launches the kernel for CUDA tensors and runs the
plain PyTorch version for CPU tensors -- nothing else.  The kernel masks
ragged T and W itself, so nothing is padded here (the TPU wrapper padded
with a = 1, x = 0).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

_PROTOTYPES = {
    "linear_scan_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
}

# the plain version is the float32 oracle: a sequential scan
linear_scan_plain = linear_scan_ref


def linear_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: h (B, T, W) in x's dtype, float32 arithmetic."""
    dev = build.check_operands("linear_scan", {"a": a, "x": x})
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"linear_scan: a{tuple(a.shape)} and x{tuple(x.shape)} "
                         "must be one (B, T, W) shape")
    B, T, W = x.shape
    if B > 65535:
        raise ValueError(f"linear_scan: batch {B} exceeds the grid's 65535")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build.load("linear_scan", _PROTOTYPES)
    build.launch(
        lib, "linear_scan_launch", dev, build.DTYPE_CODES[x.dtype],
        a.data_ptr(), x.data_ptr(), out.data_ptr(), B, T, W)
    linear_scan_cuda.launches += 1
    return out


linear_scan_cuda.launches = 0


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + x_t: the plain version for CPU tensors, else
    the kernel."""
    if x.device.type == "cpu":
        return linear_scan_plain(a, x)
    return linear_scan_cuda(a, x)
