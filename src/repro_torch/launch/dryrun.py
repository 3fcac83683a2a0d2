"""Dry run: every (arch × input shape × mesh) as one rank's program, traced.

The port of ``repro/launch/dryrun.py``.  It proves the distribution config
coherent without hardware: a fake process group of 256 (512 multi-pod)
ranks in one process builds the production meshes (``launch/mesh.py``),
the sharding policy places every leaf (``launch/sharding.py``), and rank
0's program runs on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage, no kernel), counted by ``launch/roofline.py``.  A deep model is
traced at two shallow depths and its layer period's cost multiplied out
(``at_depth``; the record's ``traced_layers``), as the reference's HLO
analysis multiplies a scanned layer's body by its trip count.

  * train pairs: the worker-stacked parameters' specs on the arch's
    ``train_view``; the rank's program is the sharded train step's
    (``launch/steps.py:build_sharded_train_step``): the gathered replica's
    forward and backward on the worker's whole batch (``worker_grad_fn``),
    SGD on the rank's shard, the ring (and pod) arithmetic on it.  Every
    rank holds its worker's whole batch, as ``launch/train.py`` hands it
    over from the host: the batch is not sharded and not gathered;
  * prefill and decode pairs: ``param_pspecs(fsdp=data)`` on the production
    mesh; the rank's program gathers the weights and runs its slice of the
    batch (the batch dim's data-like axis) through ``build_prefill_step`` /
    ``build_serve_step`` at the whole sequence or cache.  Eager execution
    has no tensor parallelism: the model axis holds shards at rest and the
    ranks along it repeat the work.

Each record holds the per-rank parameter, input and state bytes at rest,
the gathered replica's bytes, the rank's FLOPs and the analytic
``model_flops`` (the reference's formulas), the collective bytes by kind
(the port's plan: no checkpoint gather), and the roofline terms with the
dominant one, in seconds derived from the H100's constants, not measured.
A failed pair is recorded with its error.  The reference's
``_make_attn_hint`` (GSPMD sharding constraints inside attention) has no
eager counterpart and is not ported.

  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--multipod] --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as S
from repro_torch.launch import shapes as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import TrainAxes


def fake_world(world_size: int, rank: int = 0) -> None:
    """A fake default process group of ``world_size`` ranks in this process
    (collectives do nothing), for meshes of that size.  The one use of
    ``torch.testing._internal.distributed.fake_pg``, a private module.
    Never in a process that computes on a real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry run needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _shard_bytes(shapes: Dict[str, object], specs, mesh) -> int:
    return sum(S.nbytes(S.local_shape(tuple(t.shape), specs[k], mesh), t.dtype)
               for k, t in shapes.items())


def _gather_plan(plan: RL.Plan, shapes, specs, mesh,
                 stacked: bool = False) -> None:
    """An all-gather of every leaf that is sharded at rest (its local
    shard's bytes: the operand); ``stacked`` leaves' first dim is the
    worker stack, whose axes the rank does not gather."""
    for k, t in shapes.items():
        if any(e is not None for e in specs[k][1 if stacked else 0:]):
            plan.add("all-gather", S.nbytes(
                S.local_shape(tuple(t.shape), specs[k], mesh), t.dtype))


def _record(rec: dict, flops: float, written: float, inputs_read: float,
            plan: RL.Plan, model_flops: float, t0: float) -> dict:
    coll = plan.stats()
    rl = RL.Roofline(flops=flops, hbm_bytes=written + inputs_read,
                     coll_bytes=coll.total_bytes, n_devices=rec["n_devices"],
                     model_flops=model_flops).finalize()
    rec.update(
        trace_s=round(time.time() - t0, 1),
        flops=rl.flops, hbm_bytes=rl.hbm_bytes, coll_bytes=rl.coll_bytes,
        model_flops=model_flops,
        compute_s=rl.compute_s, memory_s=rl.memory_s,
        collective_s=rl.collective_s, dominant=rl.dominant,
        useful_flops_ratio=rl.useful_flops_ratio,
        coll_bytes_by_kind=coll.bytes_by_kind,
        coll_count_by_kind=coll.count_by_kind,
        roofline=f"derived from {RL.CARD} constants, not measured")
    return rec


def _depths(cfg):
    """(n1, n2, m) for tracing a model of L layers at two depths: the layer
    pattern's period p (3 for the hybrid's (rec, rec, attn), else 1), L =
    q·p + r, n1 = m·p + r and n2 = n1 + p, with m periods at n1 (2 for a
    period of one layer: a stack of one layer takes other views than a
    deeper one); None when L ≤ n2."""
    p = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    q, r = divmod(cfg.n_layers, p)
    m = 1 if p > 1 else 2
    return None if q <= m + 1 else (m * p + r, (m + 1) * p + r, q - m)


def at_depth(cost, cfg):
    """``cost(cfg) -> (flops, written bytes)`` of ``cfg`` at its depth, from
    traces at two shallow depths when it is deep: the periods of a layer
    stack are identical (same shapes, same ops), so c(L) = c(n1) + k·(c(n2)
    − c(n1)) with k the periods beyond n1, as the reference's HLO analysis
    multiplies a scanned layer's body by its trip count.  Returns (flops,
    written, the depths traced)."""
    d = _depths(cfg)
    if d is None:
        return cost(cfg) + (None,)
    n1, n2, k = d
    f1, w1 = cost(dataclasses.replace(cfg, n_layers=n1))
    f2, w2 = cost(dataclasses.replace(cfg, n_layers=n2))
    return f1 + k * (f2 - f1), w1 + k * (w2 - w1), [n1, n2]


def trace_train(cfg, shape: SH.InputShape, mesh, axes: TrainAxes,
                n_workers: int, *, microbatch: int = 1, logit_chunk: int = 512,
                rec: Optional[dict] = None) -> dict:
    """One rank's sharded train step on ``mesh`` (a ``hierarchical_view``)."""
    t0 = time.time()
    rec = dict(rec or {}, n_devices=mesh.size())
    sub = ST.replica_mesh(mesh, axes)
    n = n_workers // (2 if axes.pod else 1)

    def layout(c):
        W = ST.stacked_init(c, n_workers, None, "meta")
        specs = S.param_pspecs(W, mesh, fsdp=axes.fsdp, model=axes.model,
                               worker_axes=axes.worker_axes)
        shards = {k: S.local_shape(tuple(w.shape), specs[k], mesh)[1:]
                  for k, w in W.items()}
        return W, specs, shards

    W, specs, shards = layout(cfg)
    batch, _ = SH.train_input_specs(cfg, shape, n_workers, axes)
    plan = RL.Plan()
    _gather_plan(plan, W, specs, mesh, stacked=True)         # the replica
    for k, w in W.items():
        plan.add("collective-permute", S.nbytes(shards[k], w.dtype),
                 (2 if n > 1 else 0) + (1 if axes.pod else 0))
    plan.add("all-reduce", 4)                        # the loss
    param_bytes = _shard_bytes(W, specs, mesh)
    input_bytes = sum(S.nbytes(tuple(t.shape[1:]), t.dtype)   # the worker's
                      for t in batch.values())                  # whole batch

    def cost(c):
        Wc, sc, shc = layout(c)
        place = {k: S.placements(sc[k][1:], sub) for k in Wc}
        grad = ST.worker_grad_fn(c, microbatch=microbatch,
                                 logit_chunk=logit_chunk, remat=True)
        with _fake():
            params = {k: torch.empty(tuple(w.shape[1:]), dtype=w.dtype
                                     ).requires_grad_() for k, w in Wc.items()}
            tokens = torch.empty(tuple(batch["tokens"].shape[1:]),
                                 dtype=torch.int32)
            prefix = (torch.empty(tuple(batch["prefix"].shape[1:]),
                                  dtype=batch["prefix"].dtype)
                      if "prefix" in batch else None)
            eta = torch.empty((), dtype=torch.float32)
            wts = torch.empty((4,), dtype=torch.float32)

            def program():
                loss, g = grad(params, tokens, prefix)
                for j, k in enumerate(params):
                    shard = torch.empty(shc[k], dtype=params[k].dtype)
                    ST.sgd_(shard, S.local_shard(g[j], sub, place[k]), eta)
                    g[j] = None
                    w = wts.to(shard.dtype)
                    ring = w[0] * shard
                    if n > 1:
                        ring = (ring + w[1] * torch.empty_like(shard)
                                + w[2] * torch.empty_like(shard))
                    if axes.pod:
                        ring = (1 - w[3]) * ring + w[3] * torch.empty_like(shard)
                return loss

            return RL.trace_cost(program)[:2]

    flops, written, depths = at_depth(cost, cfg)
    from repro_torch.models.transformer import active_param_count
    model_flops = 6.0 * active_param_count(cfg) * shape.global_batch * shape.seq_len
    rec.update(n_workers=n_workers,
               param_bytes_per_device=param_bytes,
               input_bytes_per_device=input_bytes,
               state_bytes_per_device=0,
               replica_bytes=sum(S.nbytes(tuple(w.shape[1:]), w.dtype)
                                 for w in W.values()),
               traced_layers=depths)
    return _record(rec, flops, written, param_bytes + input_bytes, plan,
                   model_flops, t0)


def trace_serve(cfg, shape: SH.InputShape, mesh, *,
                rec: Optional[dict] = None) -> dict:
    """One rank's prefill or decode step on the serving ``mesh``."""
    from repro_torch.models.transformer import (active_param_count,
                                                flat_params, init_decode_state,
                                                init_model)
    t0 = time.time()
    rec = dict(rec or {}, n_devices=mesh.size())
    P = flat_params(init_model(cfg, None, "meta"))
    da = SH.data_axes(mesh)
    specs = S.param_pspecs(P, mesh, fsdp=da, model="model")
    plan = RL.Plan()
    _gather_plan(plan, P, specs, mesh)
    param_bytes = _shard_bytes(P, specs, mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def split(n, axis):                  # the rank's slice of a batch dim
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n //= sizes[a] if a is not None else 1
        return n

    state_bytes = 0
    if shape.kind == "prefill":
        batch, bspecs = SH.prefill_input_specs(cfg, shape, mesh)
        _gather_plan(plan, batch, bspecs, mesh)
        input_bytes = _shard_bytes(batch, bspecs, mesh)
        b = split(shape.global_batch, bspecs["tokens"][0])
        model_flops = (2.0 * active_param_count(cfg)
                       * shape.global_batch * shape.seq_len)
    else:
        inp, ispecs = SH.decode_input_specs(cfg, shape, mesh)
        leaves = S.state_leaves(inp["state"])
        lspecs = S.state_leaves(ispecs["state"])
        for t, sp in zip(leaves, lspecs):
            local = S.local_shape(tuple(t.shape), sp, mesh)
            state_bytes += S.nbytes(local, t.dtype)
            bdim = S.serve_batch_dim(tuple(t.shape))
            if any(e is not None for d, e in enumerate(sp) if d != bdim):
                plan.add("all-gather", S.nbytes(local, t.dtype))
        b = (split(shape.global_batch, ispecs["token"][0])
             if ispecs["token"] else shape.global_batch)
        input_bytes = 4 * b + 4
        model_flops = 2.0 * active_param_count(cfg) * shape.global_batch

    def cost(c):
        Pc = flat_params(init_model(c, None, "meta"))
        with _fake():
            params = {k: torch.empty(tuple(p.shape), dtype=p.dtype)
                      for k, p in Pc.items()}
            if shape.kind == "prefill":
                fb = {"tokens": torch.empty((b, shape.seq_len),
                                            dtype=torch.int32)}
                if c.frontend:
                    fb["prefix"] = torch.empty(
                        (b, c.n_prefix_tokens, c.d_model), dtype=c.cdtype)
                step = ST.build_prefill_step(c, cache_len=shape.seq_len)
                return RL.trace_cost(step, params, fb)[:2]
            state = init_decode_state(c, b, shape.seq_len, device="cpu",
                                      filled=True)
            token = torch.empty((b,), dtype=torch.int32)
            return RL.trace_cost(ST.build_serve_step(c), params, token, state,
                                 shape.seq_len - 1)[:2]

    flops, written, depths = at_depth(cost, cfg)
    rec.update(param_bytes_per_device=param_bytes,
               input_bytes_per_device=input_bytes,
               state_bytes_per_device=state_bytes,
               replica_bytes=sum(S.nbytes(tuple(p.shape), p.dtype)
                                 for p in P.values()),
               batch_per_rank=b, traced_layers=depths)
    return _record(rec, flops, written, param_bytes + input_bytes + state_bytes,
                   plan, model_flops, t0)


def logit_chunk_for(cfg, shape: SH.InputShape, n_workers: int,
                    microbatch: int) -> int:
    """The reference's CE chunk: one chunk's float32 logits under ~0.5 GiB
    a worker."""
    bw = shape.global_batch // n_workers // microbatch
    budget = int(0.5e9 / max(bw * cfg.vocab_size * 4, 1))
    return max(32, min(512, 1 << max(budget, 1).bit_length() - 1))


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            verbose: bool = True) -> dict:
    """One pair on the production mesh (the fake group must exist:
    ``fake_world``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    shape = SH.SHAPES[shape_name]
    cfg = SH.shape_config(get_config(arch), shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if shape.kind == "train":
        view, axes, n_workers = M.train_view(arch, multi_pod=multi_pod,
                                             device_type="cpu")
        mb = M.MICROBATCH.get(arch, 1)
        rec = trace_train(cfg, shape, view, axes, n_workers, microbatch=mb,
                          logit_chunk=logit_chunk_for(cfg, shape, n_workers, mb),
                          rec=rec)
    else:
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = trace_serve(cfg, shape, mesh, rec=rec)
    if verbose:
        print(json.dumps(rec, default=str), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED
    fake_world(512 if args.multipod else 256)
    pairs = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ASSIGNED for s in SH.SHAPES])
    results = []
    for arch, shape in pairs:
        try:
            results.append(run_one(arch, shape, multi_pod=args.multipod))
        except Exception as e:  # record the failure — it is a bug to fix
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape,
                            "mesh": "2x16x16" if args.multipod else "16x16",
                            "error": repr(e)})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = "multi" if args.multipod else "single"
        path = os.path.join(args.out, f"dryrun_{tag}.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print("wrote", path)
    ok = sum(1 for r in results if "error" not in r)
    print(f"dry-run: {ok}/{len(results)} pairs traced")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
