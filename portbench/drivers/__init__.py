"""One driver a path of the program: ``sim`` (the simulator,
``DecentralizedTrainer.run``), ``train`` (the stacked training step of
``launch/steps.py``).  A traffic file names its driver; each driver's
``run(cell, seed, seconds, trace, device, t_start)`` returns a
:class:`Outcome`."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Outcome:
    """What a driver hands the harness: the end-to-end values it measured,
    the context the per-layer readers take (traced runs), the work done in
    the window, the device's peak, and the two sides' readings of the
    first steps (``check.numbers`` compares them)."""
    end_to_end: Dict[str, float]
    attempted: int
    peak_bytes: int
    program: dict
    reference: dict
    context: Optional[dict] = None


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file's numbers."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_head=cfg.get("head_dim") or 0, d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], param_dtype=cfg["torch_dtype"],
        compute_dtype=cfg["torch_dtype"], source=cfg["source"])


def log(t_start: float, what: str) -> None:
    """A phase of the run on standard error, with the seconds since the
    process started."""
    import sys
    import time
    print(f"portbench: {what} at {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr, flush=True)


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    """Return the freed blocks of the caching allocator to the card."""
    import gc
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def profiler(device, host: bool):
    """A ``torch.profiler`` over the device's activity (and the host's
    operators with ``host``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host else []
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts or [ProfilerActivity.CPU])
