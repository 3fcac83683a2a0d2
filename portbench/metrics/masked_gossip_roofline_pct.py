"""The dense event update's share of its roofline: ``masked_gossip``'s
kernels (out = Pᵀ·W − Qᵀ·G of all N workers, a launch a leaf a round)
against the least the card could take: per leaf of D float32 elements a
round reads W and G and writes out (12·N·D bytes) and takes two N×N
products (4·N²·D FLOPs)."""
import math

from portbench.yardstick import bound_s

KERNELS = ("repro::smallmix::small_kernel", "repro::tf32mix::mix_kernel",
           "repro::tf32mix::split_kernel")


def read(ctx):
    t = ctx["window"].device_s(KERNELS)
    if not t or not ctx.get("events"):
        return None
    n = ctx["traffic"]["workers"]
    per_round = sum(bound_s(12 * n * math.prod(s), 4 * n * n * math.prod(s),
                            "float32")
                    for s in ctx["param_shapes"].values())
    return 100.0 * ctx["events"] * per_round / t
