"""The port's three example drivers against the reference's, on the CPU.

- ``quickstart``: the reference's ``examples/quickstart.py`` is a script;
  its definitions (data, graph, straggler model, loss, eval, init) are run
  here without its loop, and its loop's trainer is built from them.  Both
  sides start from the reference's W0 (its ``init_fn`` at ``PRNGKey(0)``,
  carried with ``params_from_numpy``) and run a short virtual-time budget
  at N = 16: events, virtual time and comm bytes exactly, the final loss
  and accuracy within 1e-4.
- ``straggler_ablation``: one cell of the port's own
  ``make_classification_trainer`` against ``benchmarks.common``'s, under
  the same bounds.
- ``serve_batched``: the reduced rwkv6 behind both servers from the
  reference's weights (``convert.lm_params_from_numpy``), on the
  example's requests: tokens identical.

Each example's CLI runs with ``--device cpu`` and raises without it (no
card here).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_classification_trainer as ref_cell
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro.xp.builders import mlp2nn_init as ref_mlp2nn_init
from repro_torch.configs import get_config
from repro_torch.examples import quickstart, serve_batched, straggler_ablation
from repro_torch.models import convert
from repro_torch.xp import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SHORT = 20.0         # virtual seconds: a few dozen events per run


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small runs gain nothing from more, and
    the test runner's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_quickstart() -> dict:
    """The reference quickstart's module namespace, its loop and prints
    left out."""
    path = ROOT / "examples" / "quickstart.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    tree.body = [n for n in tree.body if not isinstance(n, (ast.For, ast.Expr))]
    ns: dict = {}
    exec(compile(tree, str(path), "exec"), ns)
    return ns


def _same_run(ref, port):
    assert port.algorithm == ref.algorithm
    assert (port.total_events, port.total_time, port.total_comm_copies) == \
        (ref.total_events, ref.total_time, ref.total_comm_copies)
    assert port.param_count == ref.param_count
    assert port.comm_bytes() == ref.comm_bytes()
    assert port.final_loss == pytest.approx(ref.final_loss, abs=TOL)
    assert port.final_metric == pytest.approx(ref.final_metric, abs=TOL)


@pytest.mark.parametrize("alg", ["dsgd_aau", "ad_psgd"])
def test_quickstart_matches_the_reference(alg):
    ns = _reference_quickstart()
    assert ns["N_WORKERS"] == quickstart.N_WORKERS == 16
    w0 = jax.device_get(ns["init_fn"](jax.random.PRNGKey(0)))
    data = ns["data"]
    ref = ns["DecentralizedTrainer"](
        ns["make_scheduler"](alg, ns["graph"], ns["stragglers"]),
        ns["loss_fn"], lambda key: jax.tree.map(jnp.asarray, w0),
        lambda w, s: data.batch(w, s, 32), data.eval_batch(1024),
        eval_fn=ns["eval_fn"], eta0=0.2)
    port = quickstart.build_trainer(
        alg, "cpu", init_params=params_from_numpy(w0, device="cpu"))
    assert port.mode == ref.mode == "scan"
    r = ref.run(max_time=SHORT, eval_every=10**6)
    p = port.run(max_time=SHORT, eval_every=10**6)
    assert p.total_events >= 20
    _same_run(r, p)


def test_quickstart_init_has_the_reference_shapes():
    ns = _reference_quickstart()
    ref = jax.device_get(ns["init_fn"](jax.random.PRNGKey(0)))
    port = quickstart.init_fn(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    # N(0, 0.1²) entries, as the reference's
    for v in port.values():
        assert abs(float(v.std()) - 0.1) < 0.01


def test_straggler_ablation_cell_matches_benchmarks_common():
    w0 = jax.device_get(ref_mlp2nn_init()(jax.random.PRNGKey(0)))
    cell = dict(straggler_prob=0.2, slowdown=20.0)
    ref = ref_cell("ad_psgd", 16, **cell)
    port = straggler_ablation.make_classification_trainer(
        "ad_psgd", 16, device="cpu",
        init_params=params_from_numpy(w0, device="cpu"), **cell)
    assert port.mode == ref.mode
    _same_run(ref.run(max_time=SHORT, eval_every=10**6),
              port.run(max_time=SHORT, eval_every=10**6))


def test_serve_batched_tokens_match_the_reference():
    arch = "rwkv6-1.6b"
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    params = JT.init_model(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    reqs = serve_batched.make_requests(cfg.vocab_size, 2, 6)
    ref_reqs = [jax_serve.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                for r in reqs]
    serve_batched.BatchedServer(cfg, model, batch_slots=4,
                                cache_len=serve_batched.CACHE_LEN).run(reqs)
    jax_serve.BatchedServer(jcfg, params, batch_slots=4,
                            cache_len=serve_batched.CACHE_LEN).run(ref_reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(len(r.out) == 6 for r in reqs)


def test_serve_batched_requests_are_the_references():
    """The reference's draws: ``default_rng(0)``, prompts of 4-23 tokens."""
    rng = np.random.default_rng(0)
    for r in serve_batched.make_requests(65536, 8, 24):
        want = rng.integers(0, 65536, size=int(rng.integers(4, 24))).astype(np.int32)
        assert r.prompt.dtype == np.int32
        np.testing.assert_array_equal(r.prompt, want)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_serve_batched_cli(arch, capsys):
    assert serve_batched.main(["--arch", arch, "--device", "cpu",
                               "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert f"{arch} ({arch}-reduced): 3 requests, 12 tokens" in out


def test_quickstart_cli(monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "BUDGET", 2.0)
    assert quickstart.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["algorithm", "acc@t=50", "loss", "iters",
                                "comm-GiB"]
    assert [line.split()[0] for line in lines[1:]] == list(quickstart.ALGORITHMS)


def test_straggler_ablation_cli(monkeypatch, capsys):
    monkeypatch.setattr(straggler_ablation, "BUDGET", 1.0)
    monkeypatch.setattr(straggler_ablation, "PROBS", (0.2,))
    monkeypatch.setattr(straggler_ablation, "SLOWDOWNS", (20.0,))
    assert straggler_ablation.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["prob", *straggler_ablation.ALGORITHMS]
    assert lines[2].split()[0] == "0.20" and lines[4].split()[0] == "20x"
    assert all(0.0 <= float(a) <= 1.0 for a in lines[2].split()[1:])


@pytest.mark.parametrize("example", [quickstart, serve_batched,
                                     straggler_ablation])
def test_examples_refuse_to_fall_back_to_the_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main([])
