"""The simulator's path: ``DecentralizedTrainer.run`` of the program on the
benchmark's topology, stragglers, data and weights.

A traffic file gives the window's ``run`` call (``call``: its bound,
``max_events`` or ``max_time``, and ``eval_every``), which starts the
event process afresh, as every call does.  Set-up builds one trainer,
warms it (``warmup``: kernels, sample pools) and drives its first
``check_calls`` calls through ``run`` itself, each of the window's shape
unless ``check_call`` names another.  The same trainer then runs in the
window: calls back to back until ``--seconds`` have passed.  A DSGD-AAU
event counts one worker step, a synchronous round N.

The reference (``reference/sim.py``) works the first calls' schedules out
again from the same inputs and replays them in float64.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs
from portbench.check import gap_norm
from portbench.drivers import (Outcome, free, log, profiler, program_config,
                               synchronize)
from portbench.reference import sim as ref
from portbench.reference.model import Matmul
from portbench.yardstick import Window

TRACE_SECONDS = 3.0     # the traced window: whole `run` calls past this
REFERENCE = torch.float64   # the reference's arithmetic


def make_inputs(cell, seed: int, device) -> dict:
    """The topology, the data pool and eval batch, the initial weights."""
    cfg, tr = cell.config, cell.traffic
    n = tr["workers"]
    pool, ev = inputs.charlm_pool(tr["data"], n, cfg["vocab_size"], seed)
    return dict(adj=inputs.topology(tr["topology"], n, seed), pool=pool,
                eval=ev, W0=inputs.init_weights(cfg, seed, device))


def build(cell, seed: int, data: dict, device):
    """The program's trainer on the inputs of ``seed``."""
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.core.runner import DecentralizedTrainer
    from repro_torch.core.topology import Graph
    from repro_torch.models import lm_loss

    tr = cell.traffic
    n = tr["workers"]
    mcfg = program_config(cell.config)
    pool, W0 = data["pool"], data["W0"]
    sched = make_scheduler(tr["algorithm"], Graph(n, data["adj"]),
                           inputs.StragglerTimes(tr["stragglers"], n, seed))
    return DecentralizedTrainer(
        sched, lambda p, b: lm_loss(p, mcfg, b), lambda gen: W0,
        lambda w, s: {"tokens": pool[w, s]}, {"tokens": data["eval"]},
        eta0=tr["eta0"], eta_decay=tr["eta_decay"], mode=tr["mode"],
        batch_pool=tr["data"]["pool"], device=device)


def check_call(tr: dict) -> dict:
    """The shape of the calls the check reads."""
    return tr.get("check_call", tr["call"])


def first_calls(trainer, W0, tr: dict) -> dict:
    """The program's readings of its first ``check_calls`` calls: every
    history row's loss and [last event, workers active over its events],
    the parameters' change after the first call and after the last."""
    out = {"loss": [], "active": []}
    for c in range(tr["check_calls"]):
        res = trainer.run(**check_call(tr))
        for i, h in enumerate(res.history):
            # rows on the eval grid are over the last eval_every events,
            # the call's last row over all of them
            m = (check_call(tr)["eval_every"] if i < len(res.history) - 1
                 else res.total_events)
            out["loss"].append(h.loss)
            out["active"].append([h.k, round(h.n_active_mean * m)])
        if c == 0:
            out["grad"] = {key: gap_norm(w, W0[key])
                           for key, w in trainer.W.items()}
    out["change"] = {key: gap_norm(w, W0[key]) for key, w in trainer.W.items()}
    return out


def reference(cell, seed: int, data: dict, device, mm: Matmul,
              fault=None) -> dict:
    """The reference's readings of the first ``check_calls`` calls."""
    tr = cell.traffic
    n = tr["workers"]
    call = check_call(tr)
    times = inputs.StragglerTimes(tr["stragglers"], n, seed)
    counts = np.zeros(n, dtype=np.int64)
    rep = ref.SimReplay(cell.config, data["W0"], n,
                        torch.as_tensor(data["pool"], device=device),
                        torch.as_tensor(data["eval"], device=device), mm,
                        fault)
    W0 = {key: w[0].clone() for key, w in rep.W.items()}
    out = {"loss": [], "active": []}
    for c in range(tr["check_calls"]):
        events = ref.call_events(tr["algorithm"], data["adj"], times, counts,
                                 call)
        rows = ref.history_rows([len(w) for w, _ in events],
                                call["eval_every"])
        done = 0
        for last, active in rows:
            for k in range(done, last + 1):
                # eta decays with the event's place in its call
                workers, P = events[k]
                rep.step(workers, P, tr["eta0"] * tr["eta_decay"] ** k)
            done = last + 1
            out["loss"].append(rep.eval_loss())
            out["active"].append([last, active])
        if c == 0:
            out["grad"] = {key: gap_norm(w, W0[key]) for key, w in rep.W.items()}
    out["change"] = {key: gap_norm(w, W0[key]) for key, w in rep.W.items()}
    return out


def steps_per_event(cell) -> int:
    return cell.traffic["workers"] if cell.traffic["algorithm"] == "dsgd_sync" else 1


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    tr = cell.traffic
    data = make_inputs(cell, seed, device)
    log(t_start, "inputs made")
    trainer = build(cell, seed, data, device)
    trainer.warmup()
    log(t_start, "trainer built and warm")
    program = first_calls(trainer, data["W0"], tr)
    log(t_start, f"{tr['check_calls']} first call(s) taken")
    synchronize(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    length = min(seconds, TRACE_SECONDS) if trace else seconds
    calls, events, active = 0, 0, 0.0
    call_s = []     # each call's host seconds, for the log
    prof = profiler(device, host=True) if trace else None
    if prof is not None:
        prof.__enter__()
    cpu0 = time.thread_time()
    t0 = time.perf_counter()
    t_call = t0
    while True:
        res = trainer.run(**tr["call"])
        calls += 1
        events += res.total_events
        active += res.history[-1].n_active_mean * res.total_events
        now = time.perf_counter()
        call_s.append(now - t_call)
        t_call = now
        if now - t0 >= length:
            break
    synchronize(device)
    elapsed = time.perf_counter() - t0
    cpu = time.thread_time() - cpu0
    if prof is not None:
        prof.__exit__(None, None, None)
    steps = events * steps_per_event(cell)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    context = None
    if trace:
        context = dict(window=Window(prof, elapsed), events=events,
                       worker_steps=steps, active_sum=active,
                       param_shapes=inputs.param_shapes(cell.config))
        del prof
    log(t_start, f"window closed: {calls} calls, {events} events, "
        f"{elapsed:.3f} s, {cpu:.3f} CPU s; call seconds "
        + " ".join(f"{c:.3f}" for c in call_s))
    del trainer, res
    free(device)
    reference_out = reference(cell, seed, data, device, Matmul(REFERENCE))
    log(t_start, "reference done")
    return Outcome(
        end_to_end={"sim_worker_steps_per_s": steps / elapsed,
                    "setup_s": setup_s},
        attempted=steps, peak_bytes=peak, program=program,
        reference=reference_out, context=context)
