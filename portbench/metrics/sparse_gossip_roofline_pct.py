"""The active-set gossip's share of its roofline: ``sparse_gossip`` (the
gather and mix of the active rows) with ``scatter_rows`` (their scatter
into W and S), their kernels' device time against the least the card
could take.

Work of an event of m active workers, per leaf of D float32 elements:
the m rows of W and of the gradients read, the m new rows of W and of S
written (16·m·D bytes), and the two m×m products (4·m²·D FLOPs).  At m
up to N = 256 the bytes bound every event (4·N/peak < 16/bandwidth), so
the bound of the window is the bytes of Σm active rows."""
import math

from portbench.yardstick import PEAK_BYTES_PER_S, PEAK_FLOPS

KERNELS = ("repro::smallmix::small_kernel", "repro::tf32mix::mix_kernel",
           "repro::tf32mix::split_kernel", "scatter_rows_kernel")


def read(ctx):
    t = ctx["window"].device_s(KERNELS)
    n = ctx["traffic"]["workers"]
    if not t or not ctx.get("active_sum"):
        return None
    if 4 * n / PEAK_FLOPS["float32"] > 16 / PEAK_BYTES_PER_S:
        return None                 # an event could be bound by its FLOPs
    D = sum(math.prod(s) for s in ctx["param_shapes"].values())
    return 100.0 * (16 * ctx["active_sum"] * D / PEAK_BYTES_PER_S) / t
