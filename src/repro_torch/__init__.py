"""PyTorch/CUDA port of the DSGD-AAU decentralized-training simulator.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.aau`` ↔ ``repro.core.aau`` and so on) and imports
nothing from it.  The host-side event generation (schedulers, topologies,
scenarios) is a NumPy copy of the reference's, so both packages consume
bit-identical event streams; the device side runs on PyTorch, and every
Pallas kernel on the main path is a hand-written CUDA kernel for Hopper
(``csrc/``, built with nvcc at first use).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA on a machine without it raises.

Float32 matrix products stay in full float32 on the card: parity with the
reference is held at float32 tolerances, which TF32 (about three decimal
digits) would break.  bfloat16 products reduce in float32 (no split-K
reduction in bf16), as the reference's ``preferred_element_type=float32``.
The switches are set here, once, for the process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
