"""The port's launch stack against the JAX package (CPU): the sharding
policy, the input-shape table and abstract inputs, the production meshes
on a fake process group, the stacked two-pod gossip matrix, the dry run and
its roofline counts.

Specs are compared exactly, leaf for leaf, for every assigned arch plus
``paper-char-lm`` at full size (shapes only: the reference's
``jax.eval_shape``, the port's meta device).  The meshes and the dry run
need a process group: they run in subprocesses on the fake group
(``launch/dryrun.py:fake_world``), never in this process.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as JSH
from repro.launch import sharding as JS
from repro.launch import steps as JST
from repro.launch.mesh import WORKER_FSDP as JAX_WORKER_FSDP
from repro.launch.mesh import TrainAxes as JaxTrainAxes
from repro.models import transformer as JT
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as SH
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ASSIGNED + ("paper-char-lm",)
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    """A mesh as the reference's tests fake it: ``.shape`` alone."""
    def __init__(self, shape):
        self.shape = dict(shape)


def _key(path) -> str:
    return ".".join(str(p.key if hasattr(p, "key") else p.idx) for p in path)


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_key(p): tuple(s) for p, s in flat}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda k: JT.init_model(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return T.flat_params(T.init_model(get_config(arch), None, "meta"))


def _stack(tree, n):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape, s.dtype),
                        tree)


def _assert_divides(shapes, specs, sizes):
    for k, t in shapes.items():
        for dim, axis in zip(t.shape, specs[k]):
            if axis is None:
                continue
            n = int(np.prod([sizes[a] for a in
                             (axis if isinstance(axis, tuple) else (axis,))]))
            assert dim % n == 0, (k, tuple(t.shape), specs[k])


# ---------------------------------------------------------------------------
# Sharding policy: exact spec parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("vocab", [False, True], ids=["embed", "vocab"])
def test_serve_param_specs_equal_the_reference(arch, multi, vocab):
    sizes = MULTI if multi else SINGLE
    da = ("pod", "data") if multi else "data"
    ref = _ref_specs(JS.param_pspecs(_ref_shapes(arch), FakeMesh(sizes),
                                     fsdp=da, model="model",
                                     embed_vocab_shard=vocab))
    port = S.param_pspecs(_port_shapes(arch), sizes, fsdp=da, model="model",
                          embed_vocab_shard=vocab)
    assert set(port) == set(ref)
    assert port == ref
    _assert_divides(_port_shapes(arch), port, sizes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_train_param_specs_equal_the_reference_on_the_train_view(arch, multi):
    """WORKER_FSDP's view: (pod,) worker, fsdp (dropped at 1), model; the
    worker-stacked leaves, embed sharded both ways."""
    w, f = M.WORKER_FSDP.get(arch, (16, 1))
    sizes = dict({"pod": 2} if multi else {}, worker=w, model=16,
                 **({"fsdp": f} if f > 1 else {}))
    axes = M.TrainAxes(pod="pod" if multi else None, worker="worker",
                       fsdp="fsdp" if f > 1 else None, model="model")
    nw = w * (2 if multi else 1)
    stacked = {k: (nw,) + tuple(t.shape) for k, t in _port_shapes(arch).items()}
    for vocab in (False, True):
        ref = _ref_specs(JS.param_pspecs(
            _stack(_ref_shapes(arch), nw), FakeMesh(sizes), fsdp=axes.fsdp,
            model="model", worker_axes=axes.worker_axes, embed_vocab_shard=vocab))
        port = S.param_pspecs(stacked, sizes, fsdp=axes.fsdp, model="model",
                              worker_axes=axes.worker_axes,
                              embed_vocab_shard=vocab)
        assert port == ref
        assert all(s[0] == (axes.worker_axes if multi else "worker")
                   for s in port.values())
        _assert_divides({k: torch.empty(v, device="meta")
                         for k, v in stacked.items()}, port, sizes)


def test_worker_fsdp_and_microbatch_are_the_reference_tables():
    from repro.launch.mesh import MICROBATCH
    assert M.WORKER_FSDP == JAX_WORKER_FSDP
    assert M.MICROBATCH == MICROBATCH


def test_expert_parallel_when_divisible():
    specs = S.param_pspecs(_port_shapes("arctic-480b"), {"fsdp": 4, "model": 16},
                           fsdp="fsdp", model="model")
    assert specs["layers.ffn.w_gate"][1] == "model"     # 128 experts % 16


def test_batch_pspec_equals_the_reference():
    for wa, fsdp, seq in ((("worker",), "fsdp", "model"),
                          (("pod", "worker"), None, None)):
        shapes = {"tokens": (4, 2, 64), "prefix": (4, 2, 8, 32)}
        ref = JS.batch_pspec({k: jax.ShapeDtypeStruct(v, jnp.float32)
                              for k, v in shapes.items()}, wa, fsdp, seq)
        assert S.batch_pspec(shapes, wa, fsdp, seq) == {
            k: tuple(v) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# Shapes: the table, shape_config and abstract inputs on the meta device
# ---------------------------------------------------------------------------

def test_shape_table_is_the_reference_s():
    assert SH.SWA_WINDOW == JSH.SWA_WINDOW
    assert {k: dataclasses.astuple(v) for k, v in SH.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSH.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_config_is_the_reference_s(arch):
    for name, shape in SH.SHAPES.items():
        port = SH.shape_config(get_config(arch), shape)
        ref = JSH.shape_config(jax_get_config(arch), JSH.SHAPES[name])
        assert (port.attn_window, port.family, port.notes) == (
            ref.attn_window, ref.family, ref.notes), name
        assert port.supports_long_context
        if name == "long_500k" and port.family != "ssm":
            assert port.attn_window is not None and port.attn_window <= SH.SWA_WINDOW


def _leaves(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_input_specs_equal_the_reference(arch, multi):
    """train (worker-stacked, seq over model), prefill and decode (the
    state filled, in the reference's layer-stacked layout): shapes, dtypes
    and specs, leaf for leaf; nothing allocated."""
    sizes = MULTI if multi else SINGLE
    for name, shape in SH.SHAPES.items():
        cfg = SH.shape_config(get_config(arch), shape)
        jcfg = JSH.shape_config(jax_get_config(arch), JSH.SHAPES[name])
        if shape.kind == "train":
            w = M.WORKER_FSDP.get(arch, (16, 1))[0] * (2 if multi else 1)
            axes = M.TrainAxes(pod="pod" if multi else None, worker="worker",
                               fsdp="fsdp", model="model")
            jaxes = JaxTrainAxes(**dataclasses.asdict(axes))
            port, pspec = SH.train_input_specs(cfg, shape, w, axes)
            ref, rspec = JSH.train_input_specs(jcfg, JSH.SHAPES[name], w, jaxes)
        elif shape.kind == "prefill":
            port, pspec = SH.prefill_input_specs(cfg, shape, sizes)
            ref, rspec = JSH.prefill_input_specs(jcfg, JSH.SHAPES[name],
                                                 FakeMesh(sizes))
        else:
            port, pspec = SH.decode_input_specs(cfg, shape, sizes)
            ref, rspec = JSH.decode_input_specs(jcfg, JSH.SHAPES[name],
                                                FakeMesh(sizes))
            port = {"token": port["token"], "pos": port["pos"],
                    "state": S.state_leaves(port["state"])}
            pspec = {"token": pspec["token"], "pos": pspec["pos"],
                     "state": S.state_leaves(pspec["state"])}
            ref = {"token": ref["token"], "pos": ref["pos"],
                   "state": jax.tree.leaves(ref["state"])}
            rspec = {"token": rspec["token"], "pos": rspec["pos"],
                     "state": jax.tree.leaves(
                         rspec["state"], is_leaf=lambda x: isinstance(x, JP))}
        assert set(port) == set(ref), name
        for k in ref:
            pl = port[k] if isinstance(port[k], list) else [port[k]]
            rl = ref[k] if isinstance(ref[k], list) else [ref[k]]
            assert all(t.device.type == "meta" for t in pl)
            assert _leaves(pl) == _leaves(rl), (name, k)
            ps = pspec[k] if isinstance(pspec[k], list) else [pspec[k]]
            rs = rspec[k] if isinstance(rspec[k], list) else [rspec[k]]
            assert ps == [tuple(s) for s in rs], (name, k)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_long500k_decode_state_is_windowed(arch):
    cfg = SH.shape_config(get_config(arch), SH.SHAPES["long_500k"])
    state = T.init_decode_state(cfg, 1, SH.SHAPES["long_500k"].seq_len,
                                device="meta", filled=True)
    total = sum(x.numel() * x.element_size() for x in S.state_leaves(state))
    assert total < 4e9, f"{arch}: {total / 2**30:.1f} GiB decode state"


def test_train_specs_reject_indivisible_workers():
    axes = M.TrainAxes(pod=None, worker="worker", fsdp=None, model="model")
    batch, specs = SH.train_input_specs(get_config("qwen3-8b"),
                                        SH.SHAPES["train_4k"], 4, axes)
    assert tuple(batch["tokens"].shape) == (4, 64, 4096)
    assert specs["tokens"][0] == "worker"
    with pytest.raises(ValueError):
        SH.train_input_specs(get_config("qwen3-8b"), SH.SHAPES["train_4k"], 7, axes)


def test_filled_decode_state_positions_are_the_reference_s():
    """A decode step's mask reads the slots' positions: ``filled`` marks
    them as the reference does, and an empty state keeps -1."""
    for arch in ("mistral-nemo-12b", "recurrentgemma-2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), attn_window=16)
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(), attn_window=16)
        for cache_len in (10, 16, 40):
            for filled in (False, True):
                port = [c.positions.numpy() for c in T.init_decode_state(
                    cfg, 2, cache_len, device="cpu", filled=filled)
                    if hasattr(c, "positions")]
                ref = JT.init_decode_state(jcfg, 2, cache_len, filled=filled)
                ref = (ref.positions if hasattr(ref, "positions") else
                       [c.positions for c in ref if hasattr(c, "positions")])
                ref = [np.asarray(r) for r in ref]
                assert len(port) == len(ref) > 0
                for p, r in zip(port, ref):
                    np.testing.assert_array_equal(p, r)


def test_meta_is_for_shapes_only():
    from repro_torch.device import resolve_device
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="meta"):
        ST.build_train_step(get_config("qwen3-8b").reduced(), 1, device="meta")
    with pytest.raises(ValueError, match="meta"):
        T.init_model(get_config("qwen3-8b").reduced(),
                     torch.Generator().manual_seed(0), "meta")
    W = ST.stacked_init(get_config("qwen3-8b"), 16, None, "meta")
    assert all(w.device.type == "meta" and w.shape[0] == 16 for w in W.values())


# ---------------------------------------------------------------------------
# The stacked two-pod gossip matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("straggle", [False, True])
def test_two_pod_ring_matrix_is_the_reference_pod_gossip(straggle):
    """P = (1−γ)·blockdiag(R, R) + γ·[[0, I], [I, 0]] at n = 4 against the
    reference's ``_tree_gossip`` on a (pod, worker) = 2×2 mesh (nested
    ``vmap`` with its axis names, in process), float32."""
    from repro.launch.mesh import TrainAxes as JAxes
    W = np.random.default_rng(0).normal(size=(4, 37)).astype(np.float32)
    gw = JST.default_gossip_weights(2, True)
    if straggle:
        gw = dict(gw, left=jnp.float32(0), right=jnp.float32(0),
                  self=jnp.float32(1))
    axes = JAxes(pod="pod", worker="worker", fsdp=None, model="model")
    f = jax.vmap(jax.vmap(lambda w: JST._tree_gossip({"w": w}, axes, 2, gw)["w"],
                          axis_name="worker"), axis_name="pod")
    ref = np.asarray(f(jnp.asarray(W.reshape(2, 2, 37)))).reshape(4, 37)
    P = ST.ring_matrix(4, {k: torch.tensor(float(v)) for k, v in gw.items()},
                       pods=2)
    out = (P.T.double() @ torch.from_numpy(W).double()).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(P.sum(0).numpy(), 1.0, atol=1e-6)  # doubly
    np.testing.assert_allclose(P.sum(1).numpy(), 1.0, atol=1e-6)  # stochastic
    with pytest.raises(ValueError, match="pods"):
        ST.ring_matrix(3, {k: torch.tensor(float(v)) for k, v in gw.items()},
                       pods=2)


def test_stacked_two_pod_step_matches_its_matrix():
    """The stacked train step with pods=2 mixes every leaf by the two-pod
    matrix (SGD then Pᵀ·W, as the one-pod step is held to the reference)."""
    cfg = get_config("minicpm-2b").reduced()
    W0 = ST.stacked_init(cfg, 4, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 2, 32)).astype(np.int32))
    gw = ST.default_gossip_weights(2, True)
    W1 = {k: v.clone() for k, v in W0.items()}
    ST.build_train_step(cfg, 4, logit_chunk=16, pods=2, device="cpu")(
        W1, {"tokens": toks}, 0.05, gw)
    W2 = {k: v.clone() for k, v in W0.items()}
    one = dict(gw, left=torch.tensor(0.0), right=torch.tensor(0.0),
               self=torch.tensor(1.0), pod=torch.tensor(0.0))
    ST.build_train_step(cfg, 4, logit_chunk=16, device="cpu")(
        W2, {"tokens": toks}, 0.05, one)                  # SGD alone (P = I)
    P = ST.ring_matrix(4, gw, pods=2)
    for k in W1:
        ref = torch.einsum("nj,n...->j...", P, W2[k])
        np.testing.assert_allclose(W1[k].numpy(), ref.numpy(), atol=2e-6,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# Meshes and the dry run, on the fake process group (subprocesses)
# ---------------------------------------------------------------------------

def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_production_meshes_on_a_fake_512_rank_group():
    out = _run("""
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch import dryrun, mesh as M
        dryrun.fake_world(512)
        m1 = M.make_production_mesh(device_type="cpu")
        m2 = M.make_production_mesh(multi_pod=True, device_type="cpu")
        print("M1", m1.mesh_dim_names, m1.size())
        print("M2", m2.mesh_dim_names, m2.size())
        v, axes, n = M.train_view("grok-1-314b", multi_pod=True, device_type="cpu")
        print("GROK", v.mesh_dim_names, tuple(v.shape), n, axes.worker_axes,
              axes.batch_axes)
        v, axes, n = M.train_view("qwen3-8b", device_type="cpu")
        print("QWEN", v.mesh_dim_names, tuple(v.shape), n, axes.fsdp)
        try:
            M.hierarchical_view(m1, 4, 3)
        except ValueError as e:
            print("RAISES", "data axis" in str(e))
        # a torch without DeviceMesh._unflatten: the view built from the
        # reshaped rank tensor holds the same ranks and groups
        import torch.distributed as dist
        views = {}
        for path in ("unflatten", "reshaped"):
            if path == "reshaped":
                del DeviceMesh._unflatten
            for f in (2, 1):
                v, axes = M.hierarchical_view(m2, 16 // f, f)
                views[path, f] = (v.mesh_dim_names, v.mesh.tolist(), [
                    dist.get_process_group_ranks(v.get_group(a))
                    for a in v.mesh_dim_names])
        print("PATHS", hasattr(DeviceMesh, "_unflatten"),
              all(views["unflatten", f] == views["reshaped", f] for f in (2, 1)),
              views["reshaped", 2][0], views["reshaped", 1][0],
              views["reshaped", 2][2][1])
    """)
    assert "M1 ('data', 'model') 256" in out
    assert "M2 ('pod', 'data', 'model') 512" in out
    assert ("GROK ('pod', 'worker', 'fsdp', 'model') (2, 2, 8, 16) 4 "
            "('pod', 'worker') ('pod', 'worker', 'fsdp')") in out
    assert "QWEN ('worker', 'model') (16, 16) 16 None" in out
    assert "RAISES True" in out
    assert ("PATHS False True ('pod', 'worker', 'fsdp', 'model') "
            "('pod', 'worker', 'model') [0, 32, 64, 96, 128, 160, 192, 224]"
            ) in out


def test_dry_run_small_mesh_on_a_fake_8_rank_group():
    """As the reference's ``TestDryRunSmall``: reduced qwen3 trained on a
    (4, 2) view of 2 workers × fsdp 2, reduced rwkv6 decoding at long_500k;
    then the hierarchical views of ``TestMeshViews`` and the roofline's
    counts: a 5-step ``tanh(c @ w)`` loop's FLOPs and all-gather bytes as
    ``TestHloAnalysis`` holds the reference's, and the train plan's
    all-gather bytes from the specs' shard arithmetic."""
    out = _run("""
        import json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun as D, roofline as RL
        from repro_torch.launch import shapes as SH, sharding as S, steps as ST
        from repro_torch.launch.mesh import hierarchical_view
        torch.set_num_threads(1)
        D.fake_world(8)
        base = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        view, axes = hierarchical_view(base, 2, 2)
        print("VIEW", view.mesh_dim_names, view.shape[0], view.shape[1])
        v1, axes1 = hierarchical_view(base, 4, 1)
        print("VIEW1", v1.mesh_dim_names, axes1.fsdp)
        cfg = get_config("qwen3-8b").reduced()
        rec = D.trace_train(cfg, SH.InputShape("t", "train", 64, 8), view, axes,
                            2, logit_chunk=16)
        W = ST.stacked_init(cfg, 2, None, "meta")
        specs = S.param_pspecs(W, view, fsdp=axes.fsdp, model=axes.model,
                               worker_axes=axes.worker_axes)
        shard = sum(S.nbytes(S.local_shape(tuple(w.shape), specs[k], view),
                             w.dtype) for k, w in W.items())
        gathered = sum(S.nbytes(S.local_shape(tuple(w.shape), specs[k], view),
                                w.dtype) for k, w in W.items()
                       if any(e is not None for e in specs[k][1:]))
        print("TRAIN", json.dumps(rec))
        print("SHARD", shard, gathered)
        cfg2 = SH.shape_config(get_config("rwkv6-1.6b").reduced(),
                               SH.SHAPES["long_500k"])
        rec2 = D.trace_serve(cfg2, SH.InputShape("d", "decode", 256, 4), base)
        print("DECODE", json.dumps(rec2))
        from torch._subclasses.fake_tensor import FakeTensorMode
        plan = RL.Plan()
        with FakeTensorMode():
            w = torch.empty((5, 64, 32))     # (5, 64, 64) over model = 2
            x = torch.empty((8 // 2, 64))    # (8, 64) over data = 2
            def f():
                c = x
                for i in range(5):
                    y = torch.tanh(c @ w[i])
                    plan.add("all-gather", RL.tensor_bytes(y))
                    c = torch.cat([y, y], -1)
                return c.sum()
            flops, written, _ = RL.trace_cost(f)
        print("LOOP", flops, plan.stats().bytes_by_kind["all-gather"], written)
    """)
    lines = {ln.split(" ", 1)[0]: ln.split(" ", 1)[1]
             for ln in out.strip().splitlines()}
    assert lines["VIEW"] == "('worker', 'fsdp', 'model') 2 2"
    assert lines["VIEW1"] == "('worker', 'model') None"
    import json
    tr, dec = json.loads(lines["TRAIN"]), json.loads(lines["DECODE"])
    shard, gathered = map(int, lines["SHARD"].split())
    for rec in (tr, dec):
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["roofline"].endswith("not measured")
    assert tr["param_bytes_per_device"] == shard
    # the replica is gathered; the batch is not: every rank holds its
    # worker's whole batch (8 / 2 sequences of 64 int32 tokens)
    assert tr["coll_bytes_by_kind"]["all-gather"] == gathered
    assert tr["input_bytes_per_device"] == 4 * 64 * 4
    assert tr["coll_bytes_by_kind"]["collective-permute"] == 2 * shard
    # two workers of 4 ranks: a rank's forward and backward is about
    # 6·N·D of its worker's 4 sequences, over 4× the 6·N·D of one rank
    assert tr["useful_flops_ratio"] < 0.3
    assert dec["state_bytes_per_device"] > 0
    flops, ag, written = map(float, lines["LOOP"].split())
    assert flops == pytest.approx(5 * 2 * 4 * 32 * 64, rel=0.05)
    assert ag == pytest.approx(5 * 4 * 32 * 4, rel=0.05)
    assert written > 0


def test_dry_run_cli_records_every_pair_of_a_reduced_arch(tmp_path):
    """``main``'s loop, recording and exit code on the fake 256-rank group,
    with every arch reduced (the full-size pairs run on the card's
    machine: ``chip_smoke.py``, ``PERF.md``)."""
    out = _run(f"""
        import json, sys
        from repro_torch.configs import base
        from repro_torch.launch import dryrun as D
        real = base.get_config
        import repro_torch.configs as C
        D_get = lambda name: real(name).reduced()
        base.get_config = C.get_config = D_get
        rc = D.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                     "--out", {str(tmp_path)!r}])
        print("RC", rc)
        rc = D.main(["--arch", "qwen3-8b", "--shape", "no_such_shape"])
        print("RC", rc)
    """)
    assert "RC 0" in out and "RC 1" in out
    assert "dry-run: 1/1 pairs traced" in out and "dry-run: 0/1 pairs traced" in out
    import json
    recs = json.loads((tmp_path / "dryrun_single.json").read_text())
    assert recs[0]["arch"] == "qwen3-8b" and recs[0]["n_devices"] == 256


def test_dry_run_traces_a_deep_stack_at_two_depths():
    """``at_depth``: a deep model traced at two shallow depths and its layer
    period multiplied out gives the full trace's FLOPs exactly and its
    written bytes within 1e-3 (a small term of the stacked leaves'
    backward grows faster than linearly), for a dense stack (period 1), the
    hybrid (period 3, depth 11 = 3·3 + 2) and an MoE stack; train, prefill
    and decode."""
    out = _run("""
        import dataclasses, json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun as D, shapes as SH
        from repro_torch.launch.mesh import hierarchical_view
        torch.set_num_threads(1)
        D.fake_world(8)
        base = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        view, axes = hierarchical_view(base, 2, 2)
        at_two = D._depths
        for arch, L in (("qwen3-8b", 6), ("recurrentgemma-2b", 11),
                        ("grok-1-314b", 5)):
            cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=L)
            for kind in ("train", "prefill", "decode"):
                shape = SH.InputShape(kind, kind, 64, 8)
                recs = []
                for depths in (at_two, lambda c: None):
                    D._depths = depths
                    recs.append(D.trace_train(cfg, shape, view, axes, 2,
                                              logit_chunk=16)
                                if kind == "train" else
                                D.trace_serve(cfg, shape, base))
                D._depths = at_two
                (e, f) = recs
                print(arch, kind, e["traced_layers"], f["traced_layers"],
                      e["flops"], f["flops"], e["hbm_bytes"], f["hbm_bytes"])
    """)
    lines = [ln.split(" ", 2) for ln in out.strip().splitlines()]
    assert len(lines) == 9
    for arch, kind, rest in lines:
        depths, ef, ff, eb, fb = rest.rsplit(" ", 4)
        assert depths.startswith("[") and depths.endswith("None"), (arch, kind)
        assert float(ef) == float(ff), (arch, kind)
        assert float(eb) == pytest.approx(float(fb), rel=1e-3), (arch, kind)
