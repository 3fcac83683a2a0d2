"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

Each kernel package has ``ref.py`` (float32 oracles mirroring the
reference's ``ref.py``) and ``ops.py`` (the wrapper: the kernel for CUDA
tensors, its plain PyTorch version for CPU tensors, and a launch counter).
The CUDA sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels.build` at first use.
"""
