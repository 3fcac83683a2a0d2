"""Named experiment presets.

The port's copy of the reference's ``repro/xp/presets.py``, preset for
preset.

``paper_figures`` is the recorded configuration behind
``BENCH_paper_figures.json`` — Figures 3–5 at N ∈ {32, 64, 128, 256} on the
sparse path under three scenarios.  ``paper_figures_xl`` extends it to
N ∈ {512, 1024} (bucketed sparse path, no synchronous reference).
``smoke`` is the CI dry-run tier: every registered scenario at N = 8 for a
handful of events, proving the whole harness (spec → sweep → artifact)
stays importable and runnable; ``smoke_xl`` is its N = 512 sibling that
pins the multi-bucket dispatch path in CI.  ``trace_tables`` records the
wait-blame / straggler-tax artifact (``BENCH_trace.json``) behind
``render_tables.straggler_tax_table``.
"""
from __future__ import annotations

from repro_torch.scenarios import scenario_names
from repro_torch.xp.spec import ExperimentSpec


def paper_figures_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="paper_figures",
        algorithms=("dsgd_aau", "ad_psgd", "prague", "agp"),
        reference="dsgd_sync",
        scenarios=("paper_default", "heavy_tail", "bimodal"),
        scales=(32, 64, 128, 256),
        seeds=(0, 1),
        mode="sparse_scan",
        # probed at N∈{32, 256}: every algorithm reaches the 0.9 target
        # within ~33 unscaled virtual seconds (AD-PSGD at N=256 is the
        # slowest — its averaging lock caps throughput, the paper's point)
        max_time=30.0,
        ref_max_time=400.0,
        ref_max_events=160,
        eval_every=10,
        ref_eval_every=2,
        target_loss=0.9,
        dtype_probe=True,
    )


def paper_figures_xl_spec() -> ExperimentSpec:
    """Beyond-paper scales the bucketed lane-width ladder unlocks.

    N ∈ {512, 1024} on the sparse path only.  No synchronous reference —
    a barrier over 1024 workers would dominate the sweep's wall clock for
    a speedup denominator the paper never reports at this scale (the
    artifact keeps convergence rows; ``speedup_rows`` degrades to empty).
    """
    return ExperimentSpec(
        name="paper_figures_xl",
        algorithms=("dsgd_aau", "ad_psgd", "prague"),
        reference=None,
        scenarios=("paper_default", "heavy_tail"),
        scales=(512, 1024),
        seeds=(0,),
        mode="sparse_scan",
        block_size=128,
        # event-bounded, not time-bounded: virtual-time horizons calibrated
        # at N≤256 over-run at 4× the workers (events/second of virtual
        # time grows with n), and the point here is path coverage + wall
        # throughput, not matching a figure.
        max_events=512,
        max_time=None,
        eval_every=64,
        target_loss=0.9,
    )


def smoke_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="smoke",
        algorithms=("dsgd_aau", "ad_psgd"),
        reference="dsgd_sync",
        scenarios=scenario_names(),        # every registered scenario
        scales=(8,),
        seeds=(0,),
        # auto resolves to the dense scan at N=8 (choose_mode crossover) —
        # the sparse path's per-lane gathers only pay off at larger n, and
        # CI should exercise the resolution logic end to end
        mode="auto",
        max_events=24,
        eval_every=12,
        ref_eval_every=12,
        target_loss=0.9,
        dtype_probe=True,
        dtype_probe_events=16,
    )


def smoke_xl_spec() -> ExperimentSpec:
    """CI tier for the bucketed sparse path at N=512.

    One multi-rung algorithm (DSGD-AAU — the only scheduler whose
    ``active_buckets`` ladder has more than one rung at default settings)
    for a few blocks: proves the bucketed dispatch compiles and runs at a
    scale where the static single-bucket padding would be prohibitive.
    """
    return ExperimentSpec(
        name="smoke_xl",
        algorithms=("dsgd_aau",),
        reference=None,
        scenarios=("paper_default",),
        scales=(512,),
        seeds=(0,),
        mode="sparse_scan",
        block_size=32,
        max_events=48,
        max_time=None,
        eval_every=24,
        target_loss=0.9,
    )


def fused_smoke_spec() -> ExperimentSpec:
    """CI tier for ``mode="fused"`` — the device-resident event generator.

    The two single-edge gossip algorithms whose event processes admit a
    device-side generator (AD-PSGD, AGP) under an iid-horizon scenario, for a
    few blocks: proves the fused generate-and-consume scan compiles, runs,
    and keeps exact communication accounting end to end.  Event-bounded by
    construction — fused runs keep the virtual clock on device.
    """
    return ExperimentSpec(
        name="fused_smoke",
        algorithms=("ad_psgd", "agp"),
        reference=None,
        scenarios=("paper_default",),
        scales=(8,),
        seeds=(0,),
        mode="fused",
        block_size=16,
        max_events=48,
        max_time=None,
        eval_every=24,
        target_loss=0.9,
    )


def trace_tables_spec() -> ExperimentSpec:
    """Recorded configuration behind ``BENCH_trace.json``.

    The wait-blame / straggler-tax comparison the paper's narrative makes
    qualitatively: DSGD-AAU vs AD-PSGD against the synchronous reference,
    under the default and heavy-tailed duration regimes.  Event-bounded so
    the three algorithms attribute blame over the same number of events,
    and small enough (N = 16) that the table regenerates in seconds.
    """
    return ExperimentSpec(
        name="trace_tables",
        algorithms=("dsgd_aau", "ad_psgd"),
        reference="dsgd_sync",
        scenarios=("paper_default", "heavy_tail"),
        scales=(16,),
        seeds=(0, 1),
        mode="auto",
        max_events=200,
        max_time=None,
        ref_max_events=200,
        eval_every=100,
        ref_eval_every=100,
        target_loss=0.9,
        trace=True,
    )


PRESETS = {
    "paper_figures": paper_figures_spec,
    "paper_figures_xl": paper_figures_xl_spec,
    "smoke": smoke_spec,
    "smoke_xl": smoke_xl_spec,
    "fused_smoke": fused_smoke_spec,
    "trace_tables": trace_tables_spec,
}


def get_preset(name: str) -> ExperimentSpec:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
