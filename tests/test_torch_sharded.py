"""The sharded launch stack on ``torch.distributed`` against the JAX package
(CPU, gloo).

Real process groups never live in this process: each multi-rank run is a
set of subprocesses on the gloo backend, rendezvousing through a
``FileStore`` under the test's temporary directory (no TCP port), each
with its own timeout and a 60 s collective timeout.  The reference runs in
one subprocess with 4 host devices (``XLA_FLAGS``), as
``tests/test_distributed.py`` runs it; both sides read the same inputs:
weights from the port's seeded initialiser, tokens and gossip inputs from
NumPy seeds.  The two sides run at the same time.

Held here: ``ring_gossip`` / ``tree_ring_gossip`` on 1-4 ranks against the
reference's ``_tree_gossip`` under ``shard_map`` and the Metropolis ring
(float32 within 1e-6; bf16 stays bf16, within 2e-2), the pod edge on a
(pod, worker) = 2×2 mesh, ``graph_gossip`` on a 2×2 torus, ``placements``
through ``distribute_tensor``, the sharded train step on 4 ranks in three
layouts for a dense, a hybrid and an MoE arch (float32 atol 2e-5 / rtol
1e-4, loss 1e-5 relative), and the launcher's torchrun-style path, whose
checkpoint the reference's ``Checkpointer`` restores.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.consensus import metropolis_matrix
from repro.launch import steps as JST
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCHS = ("qwen3-8b", "recurrentgemma-2b", "grok-1-314b")
LAYOUTS = ((4, 1, 1), (2, 2, 1), (2, 1, 2))      # (worker, fsdp, model)
SEQ, BW, ETA = 32, 2, 0.05
D = 37                                           # gossip leaf width


# inputs both sides build alike ------------------------------------------------

def replica0(arch):
    """One worker's float32 weights from the port's seeded initialiser."""
    cfg = get_config(arch).reduced()
    W = ST.stacked_init(cfg, 1, torch.Generator().manual_seed(7), "cpu")
    return {k: v[0].numpy() for k, v in W.items()}


def tokens(arch, n):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(11 + n)
    return [rng.integers(0, cfg.vocab_size, (n, BW, SEQ)).astype(np.int32)
            for _ in range(2)]                   # step 0 (ring), 1 (straggler)


def gossip_input(n):
    return np.random.default_rng(n).normal(size=(n, D)).astype(np.float32)


def torus_perms():
    """A 2×2 torus's four neighbour classes (node r·2 + c): each a full
    permutation delivering node j its neighbour's value, (src, dst)."""
    def node(r, c):
        return (r % 2) * 2 + c % 2
    return [[(node(r + dr, c + dc), node(r, c)) for r in range(2) for c in range(2)]
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1))]


GRAPH_W, GRAPH_SELF = [0.1, 0.2, 0.3, 0.15], 0.25


# the reference ---------------------------------------------------------------

_REF = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config as jcfg_of
from repro.core import aau as JA
from repro.launch import sharding as JS, shapes as JSH, steps as JST
from repro.launch.mesh import TrainAxes, hierarchical_view
from repro.utils.compat import auto_axis_types, make_mesh, mesh_from_devices, shard_map
import test_torch_sharded as t

res = {}
devs = jax.devices()
for n in (1, 2, 3, 4):
    mesh = mesh_from_devices(np.array(devs[:n]), ("worker",),
                             axis_types=auto_axis_types(1))
    axes = TrainAxes(pod=None, worker="worker", fsdp=None, model="model")
    gw = JST.default_gossip_weights(n, False)
    for dt in ("float32", "bfloat16"):
        f = shard_map(lambda W: JST._tree_gossip(W, axes, n, gw), mesh=mesh,
                      in_specs=({"w": P("worker")},), out_specs={"w": P("worker")})
        x = jnp.asarray(t.gossip_input(n)).astype(dt)
        res[f"ring{n}_{dt}"] = np.asarray(f({"w": x})["w"].astype(jnp.float32))

mesh = mesh_from_devices(np.array(devs).reshape(2, 2), ("pod", "worker"),
                         axis_types=auto_axis_types(2))
axes = TrainAxes(pod="pod", worker="worker", fsdp=None, model="model")
gw = JST.default_gossip_weights(2, True)
f = shard_map(lambda W: JST._tree_gossip(W, axes, 2, gw), mesh=mesh,
              in_specs=({"w": P(("pod", "worker"))},),
              out_specs={"w": P(("pod", "worker"))})
res["pod"] = np.asarray(f({"w": jnp.asarray(t.gossip_input(4))})["w"])

mesh = mesh_from_devices(np.array(devs), ("worker",), axis_types=auto_axis_types(1))
f = shard_map(lambda x: JA.graph_gossip(x, "worker", t.torus_perms(),
                                        jnp.asarray(t.GRAPH_W, jnp.float32),
                                        jnp.float32(t.GRAPH_SELF)),
              mesh=mesh, in_specs=(P("worker"),), out_specs=P("worker"))
res["graph"] = np.asarray(f(jnp.asarray(t.gossip_input(4))))

def key(path):
    return ".".join(str(p.key if hasattr(p, "key") else p.idx) for p in path)

for arch in t.ARCHS:
    jcfg = jcfg_of(arch).reduced()
    rep = t.replica0(arch)
    for (w, fs, m) in t.LAYOUTS:
        base = make_mesh((w * fs, m), ("data", "model"),
                         axis_types=auto_axis_types(2))
        view, axes = hierarchical_view(base, w, fs)
        sds = jax.eval_shape(JST.stacked_init(jcfg, w), jax.random.PRNGKey(0))
        W = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(np.broadcast_to(rep[key(p)], s.shape)), sds)
        pspecs = JS.param_pspecs(sds, view, fsdp=axes.fsdp, model=axes.model,
                                 worker_axes=axes.worker_axes)
        _, bspecs = JSH.train_input_specs(
            jcfg, JSH.InputShape("t", "train", t.SEQ, t.BW * w), w, axes)
        ns = lambda spec: jax.tree.map(lambda s: NamedSharding(view, s), spec,
                                       is_leaf=lambda x: isinstance(x, P))
        gw0 = JST.default_gossip_weights(w, False)
        step = jax.jit(JST.build_train_step(jcfg, w, axes, view, pspecs,
                                            logit_chunk=16),
                       in_shardings=(ns(pspecs), ns(bspecs),
                                     NamedSharding(view, P()),
                                     jax.tree.map(lambda _: NamedSharding(view, P()),
                                                  gw0)))
        straggle = dict(gw0, left=jnp.float32(0), right=jnp.float32(0),
                        self=jnp.float32(1))
        tag = f"{arch}|{w}x{fs}x{m}"
        with view:
            for k, (toks, gw) in enumerate(zip(t.tokens(arch, w), (gw0, straggle))):
                W, loss = step(W, {"tokens": jnp.asarray(toks)},
                               jnp.float32(t.ETA), gw)
                res[f"{tag}|loss{k}"] = np.asarray(loss)
        flat = jax.tree_util.tree_flatten_with_path(W)[0]
        for p, v in flat:
            res[f"{tag}|W|{key(p)}"] = np.asarray(v)
np.savez(sys.argv[1], **res)
print("REF_OK")
"""


# the port, on 4 gloo ranks ---------------------------------------------------

_RANK = """
import datetime, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.core import graph_gossip, tree_ring_gossip
from repro_torch.core.aau import permute
from repro_torch.launch import sharding as S, steps as ST
from repro_torch.launch.mesh import hierarchical_view
import test_torch_sharded as t

res = {}
for n in (1, 2, 3, 4):
    group = dist.new_group(list(range(n)))
    if rank >= n:
        continue
    gw = ST.default_gossip_weights(n, False)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(t.gossip_input(n)[rank]).to(dt)
        y = tree_ring_gossip({"w": x}, group, n, gw["self"], gw["left"],
                             gw["right"])["w"]
        name = str(dt).split(".")[1]
        res[f"ring{n}_{name}"] = y.float().numpy()
        res[f"ring{n}_{name}_dtype_kept"] = np.array(y.dtype == dt)

pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "worker"))
x = torch.from_numpy(t.gossip_input(4)[rank])
gw = {k: v.to(torch.float32) for k, v in ST.default_gossip_weights(2, True).items()}
ring = tree_ring_gossip({"w": x}, pods.get_group("worker"), 2, gw["self"],
                        gw["left"], gw["right"])["w"]
other, = permute(x, pods.get_group("pod"), [[(0, 1), (1, 0)]])
res["pod"] = ((1 - gw["pod"]) * ring + gw["pod"] * other).numpy()
res["graph"] = graph_gossip(x, dist.group.WORLD, t.torus_perms(),
                            torch.tensor(t.GRAPH_W), torch.tensor(t.GRAPH_SELF)
                            ).numpy()

grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
ok = []
for spec in (("data", None), (None, "model"), ("data", "model"),
             ("model", "data"), (("data", "model"), None), (None, None)):
    pl = S.placements(spec, grid)
    d = distribute_tensor(full, grid, pl)
    ok.append(bool(torch.equal(d.full_tensor(), full))
              and bool(torch.equal(d.to_local(), S.local_shard(full, grid, pl))))
res["placements"] = np.array(ok)

for arch in t.ARCHS:
    cfg = get_config(arch).reduced()
    rep = {k: torch.from_numpy(v) for k, v in t.replica0(arch).items()}
    for (w, fs, m) in t.LAYOUTS:
        base = init_device_mesh("cpu", (w * fs, m), mesh_dim_names=("data", "model"))
        view, axes = hierarchical_view(base, w, fs)
        specs = S.param_pspecs(ST.stacked_init(cfg, w, None, "meta"), view,
                               fsdp=axes.fsdp, model=axes.model,
                               worker_axes=axes.worker_axes)
        W = ST.shard_replica(rep, view, axes, specs)
        step = ST.build_sharded_train_step(cfg, w, axes, view, specs,
                                           logit_chunk=16)
        me = ST.worker_index(view, axes)
        gw0 = ST.default_gossip_weights(w, False)
        straggle = dict(gw0, left=torch.tensor(0.0), right=torch.tensor(0.0),
                        self=torch.tensor(1.0))
        tag = f"{arch}|{w}x{fs}x{m}"
        for k, (toks, gw) in enumerate(zip(t.tokens(arch, w), (gw0, straggle))):
            W, loss = step(W, {"tokens": torch.from_numpy(toks[me])}, t.ETA, gw)
            res[f"{tag}|loss{k}"] = loss.numpy()
        for key, v in ST.gather_workers(W, view, axes).items():
            if rank == 0:
                res[f"{tag}|W|{key}"] = v.numpy()
np.savez(f"{out}/port{rank}.npz", **res)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


# the launcher, torchrun-style, on 4 gloo ranks --------------------------------

_CLI = """
import datetime, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.launch import train
rc = train.main(["--arch", "minicpm-2b", "--demo", "--steps", "2", "--seq", "32",
                 "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "1"])
dist.destroy_process_group()
print("CLI_OK", rank, rc)
"""


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), **extra)
    env.pop("JAX_PLATFORMS", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _ranks(code, world, store, *args):
    env = _env()
    return [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                              str(r), str(world), str(store), *map(str, args)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=ROOT)
            for r in range(world)]


def _wait(procs, timeout):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs the reference, the port's 4 ranks and the launcher's 4 ranks
    at once; returns (reference arrays, each rank's arrays, checkpoint
    directory)."""
    d = tmp_path_factory.mktemp("sharded")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF), str(d / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    port = _ranks(_RANK, 4, d / "store", d)
    cli = _ranks(_CLI, 4, d / "cli_store", d / "ckpt")
    _wait(port + cli + [ref], timeout=600)
    ref_arrays = dict(np.load(d / "ref.npz"))
    ranks = [dict(np.load(d / f"port{r}.npz")) for r in range(4)]
    return ref_arrays, ranks, d / "ckpt"


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_gossip_is_the_reference_ring(runs, n):
    ref, ranks, _ = runs
    x = gossip_input(n)
    Pm = (np.eye(1) if n == 1 else
          metropolis_matrix(n, [(i, (i + 1) % n) for i in range(n)]))
    got = np.stack([ranks[r][f"ring{n}_float32"] for r in range(n)])
    np.testing.assert_allclose(got, ref[f"ring{n}_float32"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, Pm.T @ x, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_bf16_ring_gossip_stays_bf16(runs, n):
    ref, ranks, _ = runs
    got = np.stack([ranks[r][f"ring{n}_bfloat16"] for r in range(n)])
    assert all(bool(ranks[r][f"ring{n}_bfloat16_dtype_kept"]) for r in range(n))
    np.testing.assert_allclose(got, ref[f"ring{n}_bfloat16"], **BF16)


def test_pod_edge_is_the_reference_s_and_keeps_the_mean(runs):
    ref, ranks, _ = runs
    got = np.stack([ranks[r]["pod"] for r in range(4)])
    np.testing.assert_allclose(got, ref["pod"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.mean(0), gossip_input(4).mean(0), atol=1e-5)
    # and it is the stacked path's two-pod matrix
    P = ST.ring_matrix(4, ST.default_gossip_weights(2, True), pods=2).numpy()
    np.testing.assert_allclose(got, P.T @ gossip_input(4), atol=1e-6)


def test_graph_gossip_on_a_torus_is_the_reference_s(runs):
    ref, ranks, _ = runs
    got = np.stack([ranks[r]["graph"] for r in range(4)])
    np.testing.assert_allclose(got, ref["graph"], atol=1e-6, rtol=0)


def test_placements_round_trip_through_distribute_tensor(runs):
    _, ranks, _ = runs
    assert all(bool(ranks[r]["placements"].all()) for r in range(4))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "w{}f{}m{}".format(*l))
def test_sharded_train_step_matches_the_reference(runs, arch, layout):
    """Two steps (a ring step, then a straggler step) on 4 gloo ranks
    against the reference's ``build_train_step`` on the same hierarchical
    view of 4 host devices, from one W0; the workers see different tokens,
    so the ring mixes distinct replicas."""
    ref, ranks, _ = runs
    tag = "{}|{}x{}x{}".format(arch, *layout)
    keys = sorted(k for k in ref if k.startswith(f"{tag}|W|"))
    assert keys and keys == sorted(k for k in ranks[0] if k.startswith(f"{tag}|W|"))
    for k in keys:
        np.testing.assert_allclose(ranks[0][k], ref[k], **TOL, err_msg=k)
    for step in (0, 1):
        for r in range(4):
            np.testing.assert_allclose(ranks[r][f"{tag}|loss{step}"],
                                       ref[f"{tag}|loss{step}"], rtol=1e-5)
    spread = max(float(np.abs(ref[k][0] - ref[k][1]).max()) for k in keys)
    assert spread > 1e-4


def test_torchrun_launcher_checkpoint_restores_in_the_reference(runs, tmp_path):
    """The sharded CLI's checkpoints: the reference's ``Checkpointer``
    restores them, and they hold the stacked CLI's parameters (same seeds,
    same straggler draws, 2 workers)."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro.configs import get_config as jax_get_config
    _, _, ckpt = runs
    like = jax.eval_shape(JST.stacked_init(jax_get_config("minicpm-2b").reduced(), 2),
                          jax.random.PRNGKey(0))
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), like)
    ck = JaxCheckpointer(str(ckpt))
    assert ck.all_steps() == [1, 2]
    tree, extra = ck.restore(like)
    assert extra == {"stream": {"cursor": [2, 2]}}
    rc = train.main(["--arch", "minicpm-2b", "--demo", "--steps", "2", "--seq",
                     "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "1"])
    assert rc == 0
    stacked, _ = JaxCheckpointer(str(tmp_path)).restore(like)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(stacked)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_torchrun_launcher_picks_the_backend_by_device_and_never_falls_back(
        monkeypatch):
    """NCCL for ``cuda``, gloo for ``cpu``; ``cuda`` without a card raises
    before any process group exists."""
    import torch.distributed as dist
    assert train.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "minicpm-2b", "--demo", "--steps", "1"])
    assert not dist.is_initialized()
