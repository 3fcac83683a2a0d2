"""The training step's path: ``launch.steps.build_train_step`` of the
program, called as ``launch/train.py`` calls it, the workers stacked on
one card.

Set-up draws the weights on the card from the seed, stacks them for the N
workers, draws every step's tokens and straggler rounds, and takes the
first steps through the step itself (the first with the step's own
``on_mix`` hook, which shows each leaf before its gossip).  The same
workers then train in the window until ``--seconds`` have passed, at a
step boundary, each step's loss read back as ``launch/train.py`` reads
it.  The reference (``reference/train.py``) follows the first steps from
the same inputs.
"""
from __future__ import annotations

import time

import torch

from portbench import inputs
from portbench.check import gap_norm
from portbench.drivers import (Outcome, free, log, profiler, program_config,
                               synchronize)
from portbench.reference.model import Matmul
from portbench.reference.train import RingReplay

TRACE_STEPS = 1         # steps in the traced window
REFERENCE = torch.float32   # the reference's arithmetic


def gossip_weights(n: int, straggler: bool) -> dict:
    """The ring's weights of a round, as ``launch/train.py`` sets them."""
    from repro_torch.launch import steps as ST
    gw = dict(ST.default_gossip_weights(n, False))
    if straggler:
        gw.update({"self": torch.tensor(1.0), "left": torch.tensor(0.0),
                   "right": torch.tensor(0.0)})
    return gw


def feed(cell, seed: int, device):
    """Every step's tokens (steps, N, B, T) and straggler rounds.  The
    first steps, which the check reads, mix on every seed: in a straggler
    round the ring is the identity, and a step that left the exchange out
    would read as a sound one.  The window's steps keep the seed's draws."""
    tr = cell.traffic
    steps = tr["first_steps"] + tr["max_window_steps"]
    toks = inputs.tokens(tr, tr["workers"], cell.config["vocab_size"],
                         steps, seed, device)
    strag = inputs.straggler_rounds(tr["straggler_prob"], steps, seed)
    strag[:tr["first_steps"]] = False
    return toks, strag


def reference(cell, seed: int, device, mm: Matmul, fault=None) -> dict:
    """The reference's readings of the first steps."""
    tr = cell.traffic
    toks, strag = feed(cell, seed, device)
    rep = RingReplay(cell.config, seed, tr["workers"], device, mm, fault)
    out = {"loss": []}
    for k in range(tr["first_steps"]):
        loss, norms = rep.step(toks[k], tr["eta"], bool(strag[k]),
                               update_norms=k == 0)
        out["loss"].append(loss)
        if k == 0:
            out["grad"] = norms
    out["change"] = rep.change_norms()
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    from repro_torch.launch import steps as ST

    cfg, tr = cell.config, cell.traffic
    n, first = tr["workers"], tr["first_steps"]
    mcfg = program_config(cfg)
    train_step = ST.build_train_step(
        mcfg, n, microbatch=tr["microbatch"], logit_chunk=tr["logit_chunk"],
        remat=True, device=device)
    W = {}
    for key in inputs.param_shapes(cfg):
        w0 = inputs.init_leaf(cfg, key, seed, device)
        W[key] = w0.unsqueeze(0).expand(n, *w0.shape).clone()
        del w0
    toks, strag = feed(cell, seed, device)
    cap = toks.shape[0]
    log(t_start, "weights and feed made")

    def w0(key):
        return inputs.init_leaf(cfg, key, seed, device)

    def step(W, k, on_mix=None):
        return train_step(W, {"tokens": toks[k % cap]}, tr["eta"],
                          gossip_weights(n, bool(strag[k % cap])), on_mix)

    program = {"loss": [], "grad": {}}
    for k in range(first):
        hook = ((lambda key, before, after:
                 program["grad"].__setitem__(key, gap_norm(before, w0(key))))
                if k == 0 else None)
        W, loss = step(W, k, hook)
        program["loss"].append(float(loss))
    program["change"] = {key: gap_norm(w, w0(key)) for key, w in W.items()}
    log(t_start, f"{first} first step(s) taken")
    synchronize(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    prof = profiler(device, host=False) if trace else None
    if prof is not None:
        prof.__enter__()
    steps = 0
    t0 = time.perf_counter()
    while True:
        W, loss = step(W, first + steps)
        float(loss)
        steps += 1
        if (steps >= TRACE_STEPS if trace
                else time.perf_counter() - t0 >= seconds):
            break
    synchronize(device)
    elapsed = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    tokens = steps * n * tr["batch"] * tr["seq_len"]
    context = None
    if trace:
        from portbench.yardstick import Window
        context = dict(window=Window(prof, elapsed), steps=steps,
                       tokens=tokens, peak_bytes=peak,
                       param_shapes=inputs.param_shapes(cfg))
        del prof
    log(t_start, f"window closed: {steps} steps, {elapsed:.3f} s")
    del W, train_step, loss
    free(device)
    reference_out = reference(cell, seed, device, Matmul(REFERENCE))
    log(t_start, "reference done")
    return Outcome(
        end_to_end={"train_tokens_per_s": tokens / elapsed, "setup_s": setup_s},
        attempted=steps, peak_bytes=peak, program=program,
        reference=reference_out, context=context)
