"""Wrapper of the swa_attention CUDA kernel: sliding-window prefill attention.

``swa_attention`` keeps the reference's (B, T, H, dh) interface
(``repro/kernels/swa_attention/ops.py``); the KV head of q head h is
h // (H // KV).  It hands the tensors to the kernel for CUDA tensors or to
the plain PyTorch version for CPU tensors -- nothing else.  In bfloat16 the
kernel reads q, k and v through TMA tensor maps with their own strides and
writes a (B, T, H, dh) output, so a projection's (B, T, H, dh) views (even
slices of one fused projection) go in and out with no layout copy; strides
a tensor map cannot take raise.  float32 runs the CUDA-core kernel, which
takes contiguous (B·H, T, dh) heads, so that path and the CPU path flatten
heads batch-major first.  The kernel masks ragged T itself, so nothing is
padded here.

``swa_attention_train`` is the training forward's attention (``lm_loss``
through ``models.layers.apply_attention``): a ``torch.autograd.Function``
whose forward is the bf16 kernel's training variant (it also writes each
row's log-sum-exp) and whose backward is ``csrc/swa_attention_bwd.cu``, or,
for CPU tensors, their plain versions (``ref.py``).  Its launch counters
are ``swa_attention_train_fwd_cuda.launches`` and
``swa_attention_train_bwd_cuda.launches``, one a call each.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swa_attention.ref import (
    swa_attention_ref, swa_attention_train_bwd_ref, swa_attention_train_ref)

_PROTOTYPES = {
    "swa_attention_f32_launch": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
    + (ctypes.c_float, ctypes.c_void_p),
    "swa_attention_bf16_launch": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
    + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p),
    "swa_attention_train_bf16_launch": (ctypes.c_void_p,) * 5
    + (ctypes.c_int,) * 6 + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p),
}
_BWD_PROTOTYPES = {
    "swa_attention_bwd_launch": (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
    + (ctypes.c_float, ctypes.c_void_p),
}
HEAD_DIMS = (64, 128, 256)   # head widths the kernel is instantiated for
TRAIN_HEAD_DIMS = (64, 128)  # head widths of the training kernels
MAX_HEADS = 65535            # B·H: the grid's second dimension

# the plain version is the float32 oracle: materialised masked softmax
swa_attention_plain = swa_attention_ref
# the training kernels' plain versions
swa_attention_train_plain = swa_attention_train_ref
swa_attention_train_bwd_plain = swa_attention_train_bwd_ref


def tma_strides(t: torch.Tensor, name: str) -> list:
    """Element strides of the (batch, position, head) dims of a (B, T, H,
    dh) bfloat16 tensor, as its tensor map takes them; raise ValueError,
    naming the kernel, for strides TMA cannot take (dh not contiguous,
    another stride off a multiple of 16 bytes, a base off 16 bytes).  A
    size-1 dim is never stepped, so its stride is replaced by dh."""
    B, T, H, dh = t.shape
    bad = []
    if dh > 1 and t.stride(3) != 1:
        bad.append("the head dim is not contiguous")
    steps = []
    for dim, size in ((0, B), (1, T), (2, H)):
        stride = t.stride(dim)
        if size == 1:
            stride = dh
        elif (stride * t.element_size()) % 16:
            bad.append(f"dim {dim}'s stride {stride} is not a multiple of "
                       f"16 bytes")
        steps.append(stride)
    if t.data_ptr() % 16:
        bad.append("its base is not 16-byte aligned")
    if bad:
        raise ValueError(f"swa_attention: {name} of shape {tuple(t.shape)} "
                         f"and strides {t.stride()} cannot be read through "
                         f"a TMA tensor map: " + "; ".join(bad))
    return steps


def _check(q, k, v, window: int, contiguous: bool) -> torch.device:
    """The checks both entries share; return the operands' device."""
    dev = build.check_operands("swa_attention", {"q": q, "k": k, "v": v},
                               contiguous=contiguous)
    dh = q.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"swa_attention: head width {dh} is not one of "
                         f"{HEAD_DIMS}")
    if window < 1:
        raise ValueError(f"swa_attention: window must be >= 1, got {window}")
    return dev


def _launch_bf16(dev, q, k, v, out, window: int, lse=None) -> bool:
    """The bfloat16 kernel on (B, T, H, dh) q and out and (B, T, KV, dh)
    k and v of any strides a tensor map takes; with ``lse`` ((B, H, T)
    float32) its training variant, which also writes each row's
    log-sum-exp.  Returns whether it launched (not for an empty output)."""
    B, T, H, dh = q.shape
    KV = k.shape[2]
    if B * H > MAX_HEADS:
        raise ValueError(f"swa_attention: {B * H} heads exceed the grid's "
                         f"{MAX_HEADS}")
    steps = [s for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
             for s in tma_strides(t, name)]
    if out.numel() == 0:
        return False
    lib = build.load("swa_attention", _PROTOTYPES)
    strides = (ctypes.c_longlong * 12)(*steps)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is None:
        build.launch(lib, "swa_attention_bf16_launch", dev, *head, B, T, H,
                     KV, dh, min(window, T), 1.0 / math.sqrt(dh),
                     ctypes.addressof(strides))
    else:
        build.launch(lib, "swa_attention_train_bf16_launch", dev, *head,
                     lse.data_ptr(), B, T, H, KV, dh, min(window, T),
                     1.0 / math.sqrt(dh), ctypes.addressof(strides))
    return True


def swa_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, n_groups: int = 1) -> torch.Tensor:
    """The CUDA kernel: q (BH, T, dh), k and v (BH / n_groups, T, dh),
    contiguous."""
    dev = _check(q, k, v, window, contiguous=True)
    if q.dim() != 3:
        raise ValueError(f"swa_attention: q must be (BH, T, dh), got {tuple(q.shape)}")
    BH, T, dh = q.shape
    if n_groups < 1 or BH % n_groups or k.shape != (BH // n_groups, T, dh) \
            or v.shape != k.shape:
        raise ValueError(
            f"swa_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not agree with n_groups={n_groups}")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        # the heads as one batch row: (1, T, BH, dh) views, no copy
        if _launch_bf16(dev, *(t.unsqueeze(0).transpose(1, 2)
                               for t in (q, k, v, out)), window):
            swa_attention_cuda.launches += 1
        return out
    if BH > MAX_HEADS:
        raise ValueError(f"swa_attention: {BH} heads exceed the grid's "
                         f"{MAX_HEADS}")
    if out.numel() == 0:
        return out
    lib = build.load("swa_attention", _PROTOTYPES)
    build.launch(
        lib, "swa_attention_f32_launch", dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), BH, T, dh, n_groups, min(window, T),
        1.0 / math.sqrt(dh))
    swa_attention_cuda.launches += 1
    return out


swa_attention_cuda.launches = 0


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int]) -> torch.Tensor:
    """Sliding-window causal self-attention over positions 0..T-1.

    q: (B, T, H, dh); k, v: (B, T, KV, dh) with H % KV == 0.  Returns
    (B, T, H, dh) in q's dtype.  ``window=None`` is plain causal attention.
    """
    B, T, H, dh = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"swa_attention: {H} heads are not a multiple of "
                         f"{KV} KV heads")
    if k.shape != (B, T, KV, dh) or v.shape != k.shape:
        raise ValueError(f"swa_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not agree")
    window = T if window is None else window
    if q.device.type != "cpu" and q.dtype == torch.bfloat16:
        dev = _check(q, k, v, window, contiguous=False)
        out = torch.empty(B, T, H, dh, dtype=q.dtype, device=q.device)
        if _launch_bf16(dev, q, k, v, out, window):
            swa_attention_cuda.launches += 1
        return out
    qf = q.transpose(1, 2).reshape(B * H, T, dh).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, T, dh).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, T, dh).contiguous()
    if q.device.type == "cpu":
        out = swa_attention_plain(qf, kf, vf, window=window, n_groups=H // KV)
    else:
        out = swa_attention_cuda(qf, kf, vf, window=window, n_groups=H // KV)
    return out.reshape(B, H, T, dh).transpose(1, 2)


# ---------------------------------------------------------------------------
# the training attention: a forward kernel that keeps the log-sum-exp and a
# backward kernel, under one torch.autograd.Function
# ---------------------------------------------------------------------------

def _check_train(what: str, q: torch.Tensor, window: int) -> None:
    """The training kernels' own checks of a (B, T, H, dh) q, beside
    ``build.check_operands``: bfloat16, a head width of
    ``TRAIN_HEAD_DIMS``, a window of at least 1, B·H within the grid."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the training kernels take bfloat16, got "
                        f"{q.dtype}")
    B, T, H, dh = q.shape
    if dh not in TRAIN_HEAD_DIMS:
        raise ValueError(f"{what}: head width {dh} is not one of "
                         f"{TRAIN_HEAD_DIMS}")
    if window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    if B * H > MAX_HEADS:
        raise ValueError(f"{what}: {B * H} heads exceed the grid's "
                         f"{MAX_HEADS}")


def swa_attention_train_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, window: int):
    """The training forward kernel: q (B, T, H, dh), k and v (B, T, KV, dh)
    bf16 of any strides a tensor map takes.  Returns (out (B, T, H, dh)
    bf16, lse (B, H, T) float32)."""
    dev = build.check_operands("swa_attention_train",
                               {"q": q, "k": k, "v": v}, contiguous=False)
    _check_train("swa_attention_train", q, window)
    B, T, H, dh = q.shape
    out = torch.empty(B, T, H, dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    if _launch_bf16(dev, q, k, v, out, window, lse=lse):
        swa_attention_train_fwd_cuda.launches += 1
    return out, lse


swa_attention_train_fwd_cuda.launches = 0


def swa_attention_train_bwd_cuda(q, k, v, out, lse, dout, *, window: int):
    """The backward kernels (two launches, one call): contiguous bf16 q,
    out, dout (B, T, H, dh) and k, v (B, T, KV, dh), the forward's lse
    (B, H, T) float32.  Returns (dq, dk, dv), bf16, deterministic."""
    dev = build.check_operands(
        "swa_attention_bwd",
        {"q": q, "k": k, "v": v, "out": out, "dout": dout})
    _check_train("swa_attention_bwd", q, window)
    B, T, H, dh = q.shape
    KV = k.shape[2]
    if (lse.device != dev or lse.dtype != torch.float32
            or lse.shape != (B, H, T) or not lse.is_contiguous()):
        raise ValueError(f"swa_attention_bwd: lse must be a contiguous "
                         f"float32 {(B, H, T)} tensor on {dev}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    bad = [name for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                                ("dout", dout)) if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"swa_attention_bwd: {bad} are not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dvec = torch.empty_like(lse)
    lib = build.load("swa_attention_bwd", _BWD_PROTOTYPES)
    build.launch(lib, "swa_attention_bwd_launch", dev,
                 *(t.data_ptr() for t in (q, k, v, out, dout, lse, dvec, dq,
                                          dk, dv)),
                 B, T, H, KV, dh, min(window, T), 1.0 / math.sqrt(dh))
    swa_attention_train_bwd_cuda.launches += 1
    return dq, dk, dv


swa_attention_train_bwd_cuda.launches = 0


class _TrainAttention(torch.autograd.Function):
    """Attention whose forward keeps only its output and each row's
    log-sum-exp, and whose backward recomputes the scores tile by tile:
    the kernels for CUDA tensors, their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cpu":
            out, lse = swa_attention_train_plain(q, k, v, window=window)
        else:
            out, lse = swa_attention_train_fwd_cuda(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = swa_attention_train_bwd_plain(q, k, v, out, lse, dout,
                                                  window=ctx.window)
        else:
            grads = swa_attention_train_bwd_cuda(
                *(t.contiguous() for t in (q, k, v, out)), lse,
                dout.contiguous(), window=ctx.window)
        return (*grads, None)


def swa_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """Differentiable causal sliding-window attention for training: the
    function of ``models.layers.blockwise_attention`` (query i sees keys
    i − window < j ≤ i), with the forward's P and the backward's P and dS
    entering their products as bf16 hi + lo parts.  It saves only its
    output and a (B, H, T) log-sum-exp, so it needs no checkpoint of its
    own.  q: (B, T, H, dh); k, v: (B, T, KV, dh), H % KV == 0.  CUDA
    tensors launch the kernels (bf16, dh 64 or 128) or raise; CPU tensors
    take the plain versions."""
    B, T, H, dh = q.shape
    KV = k.shape[2]
    if H % KV or k.shape != (B, T, KV, dh) or v.shape != k.shape:
        raise ValueError(f"swa_attention_train: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not agree")
    window = T if window is None else min(window, T)
    return _TrainAttention.apply(q, k, v, window)
