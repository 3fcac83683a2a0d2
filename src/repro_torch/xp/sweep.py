"""Multi-seed sweep runner: ExperimentSpec → RunRecords → aggregates.

The port's copy of the reference's ``repro/xp/sweep.py``; every run takes
the ``device`` its caller names (``cuda`` unless asked otherwise).

Runs every (scenario × scale × seed × algorithm) cell of a spec on the
configured execution mode (``sparse_scan`` for the paper figures), measuring
the paper's two quantities per run:

- time-to-target-loss on the virtual clock (speedup numerator/denominator,
  Figure 5a) — ``None`` when the run's budget ends above the target, which
  aggregation reports as NaN speedup plus an ``unreached`` count instead of
  a misleading 0.0;
- the loss/accuracy-vs-virtual-time history (Figures 3–4 convergence
  curves), aggregated across seeds as mean ± std at matching eval indices.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.runner import RunResult
from repro_torch.device import DeviceLike
from repro_torch.scenarios import Scenario
from repro_torch.xp.builders import build_scenario, build_trainer
from repro_torch.xp.spec import ExperimentSpec


@dataclasses.dataclass
class RunRecord:
    scenario: str
    algorithm: str
    n: int
    seed: int
    dtype: str
    wall_s: float
    t_target: Optional[float]       # virtual time to target loss (None: unreached)
    result: RunResult


@dataclasses.dataclass
class SweepResult:
    spec: ExperimentSpec
    records: List[RunRecord]
    dtype_rows: List[Dict[str, object]]
    scenario_meta: Dict[str, Dict[str, object]]
    device: str = "cuda"

    def cells(self) -> List[Tuple[str, int]]:
        return sorted({(r.scenario, r.n) for r in self.records})

    def select(self, scenario: str = None, algorithm: str = None,
               n: int = None) -> List[RunRecord]:
        out = self.records
        if scenario is not None:
            out = [r for r in out if r.scenario == scenario]
        if algorithm is not None:
            out = [r for r in out if r.algorithm == algorithm]
        if n is not None:
            out = [r for r in out if r.n == n]
        return out


def _budgets(spec: ExperimentSpec, scenario: Scenario,
             is_reference: bool) -> Tuple[dict, Optional[int]]:
    """(run kwargs, batch_pool) for one cell.

    Pools are sized from the *scaled* time budget: a worker restarts at
    most once per completed computation and every scenario's duration
    factors have a fast tail near 1× base_time, so ``2.5 × scaled budget /
    base_time`` bounds restarts per worker even for a worker that only ever
    draws the fast tail (the runner's wrap warning stays as the backstop).
    """
    ts = scenario.mean_duration_factor() if spec.time_scaled else 1.0
    if spec.max_events is not None:
        run_kw = dict(max_events=spec.max_events,
                      eval_every=spec.ref_eval_every if is_reference
                      else spec.eval_every)
        return run_kw, spec.batch_pool
    if is_reference:
        # the barrier reference is additionally event-bounded: its rounds
        # are n-fold slower on the virtual clock, and its batch pool only
        # needs one draw per round
        run_kw = dict(max_events=spec.ref_max_events,
                      max_time=spec.ref_max_time * ts if spec.ref_max_time
                      else None,
                      eval_every=spec.ref_eval_every)
        pool = spec.batch_pool or spec.ref_max_events
        return run_kw, pool
    run_kw = dict(max_time=spec.max_time * ts, eval_every=spec.eval_every)
    pool = spec.batch_pool or min(
        1024, int(math.ceil(2.5 * spec.max_time * ts / scenario.base_time)))
    return run_kw, pool


def run_cell(spec: ExperimentSpec, scenario_name: str, alg: str, n: int,
             seed: int, log: Callable[[str], None] = lambda s: None,
             dtype: Optional[str] = None, warmup: bool = False,
             device: DeviceLike = "cuda") -> RunRecord:
    """Run one (scenario, algorithm, scale, seed) cell and measure it.

    ``warmup=True`` sets the trainer up (kernels built, pools drawn, first
    calls paid) before the timed run so ``wall_s`` measures steady-state
    throughput -- the sweep's figures live on the *virtual* clock, so only
    rows that report wall-clock rates (the dtype probe) need it.  The run
    ends in an explicit fetch of its eval history, which waits for the
    device, so ``wall_s`` covers finished device work.
    """
    scenario = build_scenario(spec, scenario_name, n, seed)
    run_kw, pool = _budgets(spec, scenario, is_reference=alg == spec.reference)
    trainer = build_trainer(spec, alg, n, seed, scenario=scenario,
                            dtype=dtype, batch_pool=pool, device=device)
    if warmup:
        trainer.warmup(**{k: v for k, v in run_kw.items()
                          if k in ("max_events", "max_time")})
    t0 = time.time()
    res = trainer.run(**run_kw)
    wall = time.time() - t0
    t_target = res.time_to_loss(spec.target_loss)
    log(f"[xp] {scenario_name}/{alg}/N{n}/seed{seed}: "
        f"events={res.total_events} vtime={res.total_time:.1f} "
        f"loss={res.final_loss:.3f} "
        f"t_target={'%.2f' % t_target if t_target is not None else 'unreached'} "
        f"wall={wall:.1f}s")
    return RunRecord(scenario=scenario_name, algorithm=alg, n=n, seed=seed,
                     dtype=dtype or spec.dtype, wall_s=wall,
                     t_target=t_target, result=res)


def dtype_probe_rows(spec: ExperimentSpec,
                     log: Callable[[str], None] = lambda s: None,
                     device: DeviceLike = "cuda"
                     ) -> List[Dict[str, object]]:
    """bf16-vs-fp32 comparison row for the artifact (the dtype policy).

    One fixed cell (first scenario, first algorithm, the largest scale ≤ 64
    to keep it cheap) run under both dtype policies with an event budget, so
    the rows compare final loss and simulator throughput like-for-like.
    """
    scen = spec.scenarios[0]
    alg = spec.algorithms[0]
    n = max([s for s in spec.scales if s <= 64] or [min(spec.scales)])
    seed = spec.seeds[0]
    probe = spec.replace(max_events=spec.dtype_probe_events,
                         eval_every=max(1, spec.dtype_probe_events // 4))
    rows = []
    for dtype in ("float32", "bfloat16"):
        rec = run_cell(probe, scen, alg, n, seed, log=log, dtype=dtype,
                       warmup=True, device=device)
        rows.append({
            "dtype": dtype, "scenario": scen, "algorithm": alg, "n": n,
            "seed": seed, "events": rec.result.total_events,
            "final_loss": rec.result.final_loss,
            "final_metric": rec.result.final_metric,
            "wall_s": round(rec.wall_s, 3),
            "events_per_s": round(rec.result.total_events
                                  / max(rec.wall_s, 1e-9), 1),
        })
    return rows


def run_spec(spec: ExperimentSpec,
             log: Callable[[str], None] = lambda s: None,
             device: DeviceLike = "cuda") -> SweepResult:
    """The full sweep: scenario × scale × seed × (reference + algorithms)."""
    records: List[RunRecord] = []
    scenario_meta: Dict[str, Dict[str, object]] = {}
    for scen in spec.scenarios:
        scenario_meta[scen] = build_scenario(
            spec, scen, max(spec.scales), spec.seeds[0]).describe()
        for n in spec.scales:
            for seed in spec.seeds:
                algs = ((spec.reference,) if spec.reference else ()) \
                    + spec.algorithms
                for alg in algs:
                    records.append(run_cell(spec, scen, alg, n, seed,
                                            log=log, device=device))
    dtype_rows = (dtype_probe_rows(spec, log=log, device=device)
                  if spec.dtype_probe else [])
    return SweepResult(spec=spec, records=records, dtype_rows=dtype_rows,
                       scenario_meta=scenario_meta, device=str(device))


# ---------------------------------------------------------------------------
# Aggregation (mean ± std across seeds)
# ---------------------------------------------------------------------------

def _mean_std(vals: List[float]) -> Tuple[float, float]:
    arr = np.asarray(vals, dtype=np.float64)
    ok = arr[~np.isnan(arr)]
    if ok.size == 0:
        return float("nan"), float("nan")
    return float(ok.mean()), float(ok.std())


def speedup_rows(sweep: SweepResult) -> List[Dict[str, object]]:
    """Per (scenario, n, algorithm): speedup vs the sync reference.

    Speedup is computed per seed — t_sync(seed) / t_alg(seed) — then
    aggregated; a seed where either run never reached the target
    contributes NaN rather than polluting the mean with a fake 0.0.
    Algorithm and reference misses are counted separately (``unreached``
    vs ``unreached_ref``), and an algorithm's measured times-to-target are
    kept even when the reference's budget fell short, so "the algorithm
    never got there" and "the sync baseline never got there" stay
    distinguishable in the artifact.
    """
    spec = sweep.spec
    rows: List[Dict[str, object]] = []
    if not spec.reference:
        return rows
    for scen, n in sweep.cells():
        ref_by_seed = {r.seed: r.t_target
                       for r in sweep.select(scen, spec.reference, n)}
        for alg in spec.algorithms:
            recs = sweep.select(scen, alg, n)
            if not recs:
                continue
            speeds, t_alg, un_alg, un_ref = [], [], 0, 0
            for r in recs:
                t_ref = ref_by_seed.get(r.seed)
                if r.t_target is not None:
                    t_alg.append(r.t_target)
                else:
                    un_alg += 1
                if t_ref is None:
                    un_ref += 1
                if r.t_target is None or t_ref is None:
                    speeds.append(float("nan"))
                else:
                    speeds.append(t_ref / r.t_target)
            s_mean, s_std = _mean_std(speeds)
            t_mean, _ = _mean_std(t_alg or [float("nan")])
            tr_mean, _ = _mean_std(
                [t for t in ref_by_seed.values() if t is not None]
                or [float("nan")])
            rows.append({
                "scenario": scen, "n": n, "algorithm": alg,
                "speedup_mean": s_mean, "speedup_std": s_std,
                "t_target_mean": t_mean, "t_sync_mean": tr_mean,
                "n_seeds": len(recs), "unreached": un_alg,
                "unreached_ref": un_ref,
            })
    return rows


def telemetry_rows(sweep: SweepResult) -> List[Dict[str, object]]:
    """Per (scenario, n, algorithm): drained device-telemetry summary.

    Only populated when the spec ran with ``telemetry=True`` (each
    ``RunResult.telemetry`` carries ``repro_torch.obs.metrics.metrics_summary``).
    Seed-aggregated: utilization and staleness means average across seeds,
    the staleness histogram and comm totals sum, and the DSGD-AAU
    ``staleness_bound`` monitor reports the worst seed.
    """
    spec = sweep.spec
    rows: List[Dict[str, object]] = []
    algs = ((spec.reference,) if spec.reference else ()) + spec.algorithms
    for scen, n in sweep.cells():
        for alg in algs:
            tels = [r.result.telemetry for r in sweep.select(scen, alg, n)
                    if r.result.telemetry is not None]
            if not tels:
                continue
            hist = np.sum([t["stale_hist"] for t in tels], axis=0)
            row: Dict[str, object] = {
                "scenario": scen, "n": n, "algorithm": alg,
                "n_seeds": len(tels),
                "utilization_mean": round(float(np.mean(
                    [t["utilization_mean"] for t in tels])), 6),
                "utilization_min": round(float(np.min(
                    [min(t["utilization"]) for t in tels])), 6),
                "stale_mean": round(float(np.mean(
                    [t["stale_mean"] for t in tels])), 6),
                "stale_max": int(max(t["stale_max"] for t in tels)),
                "stale_hist": [int(v) for v in hist],
                "comm_copies": int(sum(t["comm_copies"] for t in tels)),
                "grad_steps_total": int(sum(sum(t["grad_steps"])
                                            for t in tels)),
            }
            bounds = [t["staleness_bound"] for t in tels
                      if t.get("staleness_bound") is not None]
            if bounds:
                row["staleness_bound"] = {
                    "bound": bounds[0]["bound"],
                    "observed_max": max(b["observed_max"] for b in bounds),
                    "ok": all(b["ok"] for b in bounds),
                }
            occs = [t["bucket_occupancy"] for t in tels
                    if t.get("bucket_occupancy")]
            if occs:
                agg: Dict[int, Dict[str, float]] = {}
                for occ in occs:
                    for r_ in occ:
                        a = agg.setdefault(int(r_["A"]),
                                           {"events": 0, "lanes": 0.0})
                        a["events"] += int(r_["events"])
                        a["lanes"] += r_["lane_fill"] * r_["events"] * r_["A"]
                row["bucket_occupancy"] = [
                    {"A": A, "events": a["events"],
                     "lane_fill": round(a["lanes"] / (a["events"] * A), 6)}
                    for A, a in sorted(agg.items())]
            rows.append(row)
    return rows


def trace_rows(sweep: SweepResult) -> List[Dict[str, object]]:
    """Per (scenario, n, algorithm): wait-blame / straggler-tax summary.

    Only populated when the spec ran with ``trace=True`` (each
    ``RunResult.trace`` carries
    ``repro_torch.obs.critical_path.straggler_tax``).  Seed-aggregated: the tax,
    critical-path wait fraction and blame concentration (largest single
    worker's share of total blame) average across seeds; ``blame_top`` is
    reported for the first seed, whose stream the recorded artifacts pin.
    """
    spec = sweep.spec
    rows: List[Dict[str, object]] = []
    algs = ((spec.reference,) if spec.reference else ()) + spec.algorithms
    for scen, n in sweep.cells():
        for alg in algs:
            trcs = [r.result.trace for r in sweep.select(scen, alg, n)
                    if r.result.trace is not None]
            if not trcs:
                continue
            conc = [
                (max(t["blame"]) / t["blame_total"])
                if t["blame_total"] > 0 else 0.0
                for t in trcs]
            rows.append({
                "scenario": scen, "n": n, "algorithm": alg,
                "n_seeds": len(trcs),
                "events": int(np.mean([t["events"] for t in trcs])),
                "straggler_tax_mean": round(float(np.mean(
                    [t["straggler_tax"] for t in trcs])), 6),
                "busy_t_mean": round(float(np.mean(
                    [t["busy_t"] for t in trcs])), 6),
                "wait_t_mean": round(float(np.mean(
                    [t["wait_t"] for t in trcs])), 6),
                "blame_total_mean": round(float(np.mean(
                    [t["blame_total"] for t in trcs])), 6),
                "residual_wait_mean": round(float(np.mean(
                    [t["residual_wait"] for t in trcs])), 6),
                "blame_concentration": round(float(np.mean(conc)), 6),
                "blame_top": trcs[0]["blame_top"],
                "cp_wait_frac_mean": round(float(np.mean(
                    [t["critical_path"]["wait_frac"] for t in trcs])), 6),
            })
    return rows


def convergence_rows(sweep: SweepResult,
                     max_points: int = 80) -> List[Dict[str, object]]:
    """Per (scenario, n, algorithm): loss-vs-virtual-time curve, seed-averaged.

    Histories are aligned by eval index (every seed evaluates on the same
    event grid) and truncated to the shortest seed; curves longer than
    ``max_points`` are subsampled evenly so the artifact stays readable.
    """
    spec = sweep.spec
    rows: List[Dict[str, object]] = []
    algs = ((spec.reference,) if spec.reference else ()) + spec.algorithms
    for scen, n in sweep.cells():
        for alg in algs:
            recs = sweep.select(scen, alg, n)
            if not recs:
                continue
            # The runner always appends a final eval point: on the eval
            # grid it duplicates the last grid point; in time-bounded runs
            # it sits off-grid at a per-seed event count.  Trim each seed's
            # duplicate, then aggregate only the prefix where every seed
            # evaluated at the *same* event count — never average one
            # seed's final eval with another's mid-run grid point.
            hists = []
            for r in recs:
                h = r.result.history
                if len(h) >= 2 and h[-1].k == h[-2].k:
                    h = h[:-1]
                hists.append(h)
            L = min(len(h) for h in hists)
            while L and not all(h[L - 1].k == hists[0][L - 1].k
                                for h in hists):
                L -= 1
            if L == 0:
                continue
            idx = np.unique(np.linspace(0, L - 1, min(L, max_points),
                                        dtype=int))
            points = []
            for i in idx:
                losses = [h[i].loss for h in hists]
                metrics = [h[i].metric for h in hists]
                times = [h[i].time for h in hists]
                lm, ls = _mean_std(losses)
                mm, _ = _mean_std(metrics)
                tm, _ = _mean_std(times)
                points.append({
                    "k": hists[0][i].k, "time_mean": round(tm, 4),
                    "loss_mean": round(lm, 5), "loss_std": round(ls, 5),
                    "metric_mean": round(mm, 5),
                })
            rows.append({"scenario": scen, "n": n, "algorithm": alg,
                         "n_seeds": len(recs), "points": points})
    return rows
