"""The training step's gossip's share of its roofline: ``gossip_mix``'s
kernels (out = Pᵀ·W of the N workers' copies of a leaf, a launch a leaf a
step) against the least the card could take: per leaf of D elements a
step reads W and writes out (2·N·D elements in the parameter dtype) and
takes one N×N product (2·N²·D FLOPs)."""
import math

from portbench.yardstick import DTYPE_BYTES, bound_s

KERNELS = ("repro::smallmix::small_kernel", "repro::tf32mix::mix_kernel",
           "repro::tf32mix::split_kernel")


def read(ctx):
    t = ctx["window"].device_s(KERNELS)
    if not t or not ctx.get("steps"):
        return None
    n = ctx["traffic"]["workers"]
    dt = ctx["config"]["torch_dtype"]
    per_step = sum(bound_s(2 * n * math.prod(s) * DTYPE_BYTES[dt],
                           2 * n * n * math.prod(s), dt)
                   for s in ctx["param_shapes"].values())
    return 100.0 * ctx["steps"] * per_step / t
