"""Wrappers of the masked_gossip and gossip_mix CUDA kernels.

``masked_gossip_mix`` is the op the dense scan calls once per leaf per
event: out = Pᵀ·(W − diag(η·mask)·G) for any (N, ...) leaf.  It flattens the
leaf to (N, D), folds the step into a second matrix Q = diag(η·mask)·P in
the leaf's dtype (as the reference's ops do), and hands (W, G, P, Q) to
``masked_gossip_update``, which launches the kernel for CUDA tensors and
runs the plain PyTorch version for CPU tensors -- nothing else.  The kernel
is the two-operand-pair case of the gossip_mix kernels' product,
out = [−Q; P]ᵀ·[G; W].

``gossip_mix`` is the plain mix out = Pᵀ·W of any (N, ...) leaf (the
per-event step's mixing after its elementwise gradient step), and
``gossip_mix_batched`` the same over E stacked problems, out[e] =
P[e]ᵀ·W[e] for any (E, N, ...) leaf.  Both run their plain versions for
CPU tensors and launch the ``gossip_mix`` kernels otherwise.  The kernels
mask ragged N and D themselves, so nothing is padded here.

Each library has two bodies and one rule, ``SMALL_N`` of
``csrc/small_mix.cuh``: at N ≤ ``SMALL_N`` one launch of a CUDA-core body
built for bytes, above it the 3xTF32 tensor-core body, a prepass that
splits Pᵀ (and −Qᵀ) into TF32 parts in a scratch, kept per stream and
shape, then the product.  The wrappers ask the library which body its
rule runs (``*_kernels``) and hand a scratch only to that one.  Every
``*_cuda`` wrapper takes ``body`` (None: the rule; "cores" or "tensor":
that body, forced, to measure or test both at one N; the CUDA-core body
takes N ≤ ``CORES_MAX_N``) and counts one launch per call, whichever body
ran; ``gossip_mix_kernels`` and ``masked_gossip_kernels`` give the device
kernels a call launches.  Nothing falls back: a body that fails raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_PROTOTYPES = {
    "masked_gossip_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 6
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    "masked_gossip_kernels": (ctypes.c_int,),
}
_MIX_PROTOTYPES = {
    "gossip_mix_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 4
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    "gossip_mix_batched_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 4
    + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    "gossip_mix_kernels": (ctypes.c_int,),
}
# a caller may force the CUDA-core body up to N = CORES_MAX_N
# (csrc/small_mix.cuh's MAX_RB, a register limit); the rule itself lives
# in the C dispatch alone (``*_kernels`` below)
CORES_MAX_N = 32
# the C entries' body codes: the dispatch rule, or one body forced
_BODIES = {None: 0, "cores": 1, "tensor": 2}


def _body(what: str, body, N: int) -> int:
    """The C entry's code of ``body`` at N rows; raises ValueError, before
    anything is built or launched, for an unknown body or for "cores"
    above ``CORES_MAX_N``."""
    if body not in _BODIES:
        raise ValueError(f"{what}: body must be one of "
                         f"{sorted(map(str, _BODIES))}, got {body!r}")
    if body == "cores" and N > CORES_MAX_N:
        raise ValueError(f"{what}: the CUDA-core body takes N <= "
                         f"{CORES_MAX_N}, got N = {N}")
    return _BODIES[body]


def gossip_mix_kernels(N: int) -> int:
    """Device kernels one ``gossip_mix_cuda`` or ``gossip_mix_batched_cuda``
    call launches at N rows under the rule: 1 (the CUDA-core body) or 2
    (the split prepass and the tensor-core body).  Builds the library if
    needed."""
    return build.load("gossip_mix", _MIX_PROTOTYPES).gossip_mix_kernels(N)


def masked_gossip_kernels(N: int) -> int:
    """Device kernels one ``masked_gossip_cuda`` call launches at N rows
    under the rule, as :func:`gossip_mix_kernels`."""
    return build.load("masked_gossip", _PROTOTYPES).masked_gossip_kernels(N)


_SCRATCH: dict = {}


def _split_p_scratch(E: int, N: int, device: torch.device,
                     pairs: int = 1) -> torch.Tensor:
    """Scratch of the tensor-core body: Pᵀ (after −Qᵀ, for ``pairs=2``)
    split into TF32 hi and lo parts, (E, 2, N, pairs·Kp) float32 with
    Kp = N rounded up to 32.

    One buffer per (device, stream, shape), kept for the process: a call's
    prepass writes it and its main kernel reads it, both on the current
    stream, so the next call on that stream may write it again.  The dense
    scan calls the kernel per leaf per event; an allocation per call was
    host time on a path bound by the host."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream, E, N, pairs)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        kp = -(-N // 32) * 32
        scratch = _SCRATCH[key] = torch.empty(
            (E, 2, N, pairs * kp), dtype=torch.float32, device=device)
    return scratch


def masked_gossip_plain(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                        Q: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ·W − Qᵀ·G on (N, D) operands, in float32, cast to W's dtype."""
    f32 = torch.float32
    out = (torch.einsum("nd,nj->jd", W.to(f32), P.to(f32))
           - torch.einsum("nd,nj->jd", G.to(f32), Q.to(f32)))
    return out.to(W.dtype)


def masked_gossip_cuda(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                       Q: torch.Tensor, *, body: str | None = None
                       ) -> torch.Tensor:
    """The CUDA kernel: out = Pᵀ·W − Qᵀ·G, W/G (N, D), P/Q (N, N).

    The C dispatch picks the body from N (the CUDA-core body at N ≤
    small_mix.cuh's ``SMALL_N``); ``body`` ("cores": the CUDA-core body, N ≤
    ``CORES_MAX_N`` only; "tensor": the tensor-core body) forces one."""
    if W.dim() != 2:
        raise ValueError(f"masked_gossip: W must be (N, D), got {tuple(W.shape)}")
    N, D = W.shape
    code = _body("masked_gossip", body, N)
    dev = build.check_operands("masked_gossip",
                               {"W": W, "G": G, "P": P, "Q": Q})
    if G.shape != W.shape or P.shape != (N, N) or Q.shape != (N, N):
        raise ValueError(
            f"masked_gossip: shapes W{tuple(W.shape)} G{tuple(G.shape)} "
            f"P{tuple(P.shape)} Q{tuple(Q.shape)} do not agree")
    out = torch.empty_like(W)
    if out.numel() == 0:
        return out
    lib = build.load("masked_gossip", _PROTOTYPES)
    scratch = (_split_p_scratch(1, N, dev, pairs=2).data_ptr()
               if code == 2 or (code == 0 and lib.masked_gossip_kernels(N) == 2)
               else None)
    build.launch(
        lib, "masked_gossip_launch", dev, build.DTYPE_CODES[W.dtype],
        W.data_ptr(), G.data_ptr(), P.data_ptr(), Q.data_ptr(), out.data_ptr(),
        scratch, N, D, code)
    masked_gossip_cuda.launches += 1
    return out


masked_gossip_cuda.launches = 0


def masked_gossip_update(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                         Q: torch.Tensor) -> torch.Tensor:
    """Pᵀ·W − Qᵀ·G: the plain version for CPU tensors, else the kernel."""
    if W.device.type == "cpu":
        return masked_gossip_plain(W, G, P, Q)
    return masked_gossip_cuda(W, G, P, Q)


def masked_gossip_mix(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                      scaled_mask: torch.Tensor) -> torch.Tensor:
    """Fused event update: out = Pᵀ·(W − diag(scaled_mask)·G), any (N, ...) W.

    ``scaled_mask`` is η·grad_mask (length N).  P and Q reach the kernel in
    W's dtype; the kernel accumulates in float32.
    """
    N = W.shape[0]
    flat_w = W.reshape(N, -1).contiguous()
    flat_g = G.reshape(N, -1).to(flat_w.dtype).contiguous()
    P = P.to(flat_w.dtype)
    Q = (scaled_mask.to(flat_w.dtype)[:, None] * P).contiguous()
    out = masked_gossip_update(flat_w, flat_g, P.contiguous(), Q)
    return out.reshape(W.shape)


# -- plain mix --------------------------------------------------------------

def gossip_mix_plain(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ·W on (N, D) operands, in float32, cast to W's dtype."""
    f32 = torch.float32
    return torch.einsum("nd,nj->jd", W.to(f32), P.to(f32)).to(W.dtype)


def gossip_mix_cuda(W: torch.Tensor, P: torch.Tensor, *,
                    body: str | None = None) -> torch.Tensor:
    """The CUDA kernel: out = Pᵀ·W, W (N, D), P (N, N); ``body`` as in
    :func:`masked_gossip_cuda`."""
    if W.dim() != 2 or P.shape != (W.shape[0], W.shape[0]):
        raise ValueError(f"gossip_mix: shapes W{tuple(W.shape)} "
                         f"P{tuple(P.shape)} are not (N, D) and (N, N)")
    N, D = W.shape
    code = _body("gossip_mix", body, N)
    dev = build.check_operands("gossip_mix", {"W": W, "P": P})
    out = torch.empty_like(W)
    if out.numel() == 0:
        return out
    lib = build.load("gossip_mix", _MIX_PROTOTYPES)
    scratch = (_split_p_scratch(1, N, dev).data_ptr()
               if code == 2 or (code == 0 and lib.gossip_mix_kernels(N) == 2)
               else None)
    build.launch(
        lib, "gossip_mix_launch", dev, build.DTYPE_CODES[W.dtype],
        W.data_ptr(), P.data_ptr(), out.data_ptr(), scratch, N, D, code)
    gossip_mix_cuda.launches += 1
    return out


gossip_mix_cuda.launches = 0


def gossip_mix(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out[j] = Σ_i P[i, j]·W[i] for any (N, ...) leaf: the plain version
    for CPU tensors, else the kernel.  P reaches it in W's dtype."""
    N = W.shape[0]
    flat = W.reshape(N, -1).contiguous()
    P = P.to(flat.dtype).contiguous()
    out = (gossip_mix_plain(flat, P) if flat.device.type == "cpu"
           else gossip_mix_cuda(flat, P))
    return out.reshape(W.shape)


# -- batched mix ------------------------------------------------------------

def gossip_mix_batched_plain(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out[e] = P[e]ᵀ·W[e] on (E, N, D) operands, in float32, cast to W's
    dtype."""
    f32 = torch.float32
    return torch.einsum("end,enj->ejd", W.to(f32), P.to(f32)).to(W.dtype)


def gossip_mix_batched_cuda(W: torch.Tensor, P: torch.Tensor, *,
                            body: str | None = None) -> torch.Tensor:
    """The CUDA kernel: out[e] = P[e]ᵀ·W[e], W (E, N, D), P (E, N, N);
    ``body`` as in :func:`masked_gossip_cuda`."""
    if W.dim() != 3 or P.shape != (W.shape[0], W.shape[1], W.shape[1]):
        raise ValueError(f"gossip_mix_batched: shapes W{tuple(W.shape)} "
                         f"P{tuple(P.shape)} are not (E, N, D) and (E, N, N)")
    E, N, D = W.shape
    code = _body("gossip_mix_batched", body, N)
    dev = build.check_operands("gossip_mix_batched", {"W": W, "P": P})
    out = torch.empty_like(W)
    if out.numel() == 0:
        return out
    lib = build.load("gossip_mix", _MIX_PROTOTYPES)
    scratch = (_split_p_scratch(E, N, dev).data_ptr()
               if code == 2 or (code == 0 and lib.gossip_mix_kernels(N) == 2)
               else None)
    build.launch(
        lib, "gossip_mix_batched_launch", dev, build.DTYPE_CODES[W.dtype],
        W.data_ptr(), P.data_ptr(), out.data_ptr(), scratch, E, N, D, code)
    gossip_mix_batched_cuda.launches += 1
    return out


gossip_mix_batched_cuda.launches = 0


def gossip_mix_batched(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out[e] = P[e]ᵀ·W[e] for any (E, N, ...) leaf: the plain version for
    CPU tensors, else the kernel.  P reaches it in W's dtype."""
    E, N = W.shape[:2]
    flat = W.reshape(E, N, -1).contiguous()
    P = P.to(flat.dtype).contiguous()
    out = (gossip_mix_batched_plain(flat, P) if flat.device.type == "cpu"
           else gossip_mix_batched_cuda(flat, P))
    return out.reshape(W.shape)
