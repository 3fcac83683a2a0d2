"""Each cell at a tiny size on the CPU: a sound run comes out correct, and
a run with the program's timed path broken underneath comes out not
correct, once for each fault the cell can have: a step that leaves the
state unchanged, half of each batch left out (the mean over the rest),
the exchange between workers left out.  The harness's look for a card is
skipped; the rest of a run is driven as on the card, the cell's own
limits judging."""
import json
import math
import time

import pytest
import torch

from portbench import harness
from portbench.conftest import tiny_cell

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 7


def half_batch(orig):
    def lm_loss(params, cfg, batch, *a, **k):
        t = batch["tokens"]
        t = t[:t.shape[0] // 2] if t.shape[0] > 1 else t[:, :t.shape[1] // 2]
        return orig(params, cfg, dict(batch, tokens=t), *a, **k)
    return lm_loss


def identity_mix(orig, at):
    def mix(*args):
        args = list(args)
        n = args[at].shape[0]
        args[at] = torch.eye(n, dtype=args[at].dtype, device=args[at].device)
        return orig(*args)
    return mix


def unchanged_scan(orig):
    return lambda W, S, y, ptr, *a, **k: (W, S, y, ptr)


# (module, attribute, wrapper of the original) for each planted fault
FAULTS = {
    "sim": {
        "unchanged": [("repro_torch.core.runner", "sparse_gossip_scan", unchanged_scan),
                      ("repro_torch.core.runner", "masked_gossip_scan", unchanged_scan)],
        "half_batch": [("repro_torch.models", "lm_loss", half_batch)],
        "no_exchange": [("repro_torch.core.aau", "active_set_operands",
                         lambda o: identity_mix(o, 0)),
                        ("repro_torch.core.aau", "masked_gossip_mix",
                         lambda o: identity_mix(o, 2))]},
    "train": {
        "unchanged": [("repro_torch.launch.steps", "sgd_",
                       lambda o: lambda w, g, eta: None),
                      ("repro_torch.launch.steps", "_tree_gossip",
                       lambda o: lambda W, P, on_mix=None: W)],
        "half_batch": [("repro_torch.launch.steps", "lm_loss", half_batch)],
        "no_exchange": [("repro_torch.launch.steps", "ring_matrix",
                         lambda o: lambda n, w, pods=1: torch.eye(n))]},
}


def run(cell):
    return harness.execute(cell, SEED, 0.05, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run(workload):
    """A sound run comes out correct where the tiny size reads as the
    card does (float32: a thousandth of the limits); a bfloat16 cell's
    tiny readings swing by more than its card's, so there the run need
    only end with every number read."""
    cell = tiny_cell(workload)
    result = run(cell)
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    if cell.config["torch_dtype"] == "float32":
        assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    import importlib
    cell = tiny_cell(workload)
    for module, name, wrap in FAULTS[cell.traffic["driver"]][fault]:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    result = run(cell)
    assert not result["correct"], result["checks"]
