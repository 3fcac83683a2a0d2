"""Float32 oracle of the linear_scan kernel (mirrors the reference's
``repro/kernels/linear_scan/ref.py:linear_scan_ref``)."""
import torch


def linear_scan_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + x_t over axis 1, h_0 = 0.  a, x: (B, T, W).

    A sequential scan in float32, returned in x's dtype.
    """
    a32, x32 = a.to(torch.float32), x.to(torch.float32)
    out = torch.empty_like(x32)
    h = torch.zeros_like(x32[:, 0])
    for t in range(x32.shape[1]):
        h = torch.addcmul(x32[:, t], a32[:, t], h)
        out[:, t] = h
    return out.to(x.dtype)
