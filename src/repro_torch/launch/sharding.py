"""Sharding policy: parameter, batch and decode-state specs for every arch.

The port of ``repro/launch/sharding.py``, with the same rules.  A path-based
rule engine gives each parameter leaf a spec over (fsdp, model):
"contracting-in" matrices shard (fsdp → model), "projecting-out" matrices
(model → fsdp), expert stacks shard E over model when it divides (expert
parallelism), and every other dimension falls back to replication where it
does not divide the axis.  The same rules serve training (the fsdp axis is
``"fsdp"`` inside a worker replica) and serving (``"data"``: ZeRO-style
fully sharded inference).

A spec is a plain tuple with one entry per tensor dimension: an axis name,
a tuple of names (sharded over their product, the first the major) or
``None``; it equals ``tuple(P)`` of the reference's ``PartitionSpec``.
``placements`` turns one into the DTensor placements of a ``DeviceMesh``.
Leaves are the port's dotted keys (``layers.attn.wq``); the path rules read
them with ``/`` for ``.``, the reference's pytree path.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import axis_sizes

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

# matrices whose *first* matmul dim is the big contraction (out-projections)
_OUT_PROJ = ("wo", "w_down", "w_out", "w_v")   # w_v = rwkv channel-mix down-proj
_SMALL = ("ln", "norm", "bias", "mu_", "decay_w0", "lam", "bonus_u",
          "conv_kernel", "conv_bias", "b_a", "b_x", "router", "decay_A",
          "decay_B")


def path_of(key: str) -> str:
    """The reference's pytree path of a flat key: ``layers.0.rec.w_in`` →
    ``layers/0/rec/w_in``."""
    return key.replace(".", "/")


def _div(dim: int, mesh, axis):
    """``axis`` if ``dim`` divides its (product) size and every name exists
    in the mesh, else None.  ``axis`` may be a name or a tuple of names
    (e.g. ("pod", "data"): multi-pod serving treats both as one data-like
    axis).  ``mesh`` is a ``DeviceMesh`` or anything with a ``{name: size}``
    ``.shape`` (or such a mapping)."""
    if axis is None:
        return None
    sizes = axis_sizes(mesh)
    axes = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for a in axes:
        if a not in sizes:
            return None
        size *= sizes[a]
    return axis if dim % size == 0 else None


def leaf_spec(path_s: str, shape: Tuple[int, ...], mesh,
              fsdp: Optional[str], model: str,
              stacked_layers: bool, embed_vocab_shard: bool = False) -> Spec:
    """Spec of one (un-worker-stacked) parameter leaf at pytree path
    ``path_s``."""
    nd = len(shape)
    leading: Spec = ()
    body = shape
    if stacked_layers and nd >= 3 and not any(s in path_s for s in ("embed", "head")):
        leading = (None,)            # layer-stack axis
        body = shape[1:]
        nd -= 1

    name = path_s.rsplit("/", 1)[-1]
    if any(s in path_s.rsplit("/", 2)[-1] or s in name for s in _SMALL) or nd <= 1:
        return leading + (None,) * nd

    if nd == 3 and body[0] > 4:      # (E, d, f) expert stacks
        e_axis = _div(body[0], mesh, model)
        if e_axis:                   # expert parallel over model
            return leading + (e_axis, _div(body[1], mesh, fsdp), None)
        # tensor-parallel within experts
        if name in _OUT_PROJ:
            return leading + (None, _div(body[1], mesh, model),
                              _div(body[2], mesh, fsdp))
        return leading + (None, _div(body[1], mesh, fsdp),
                          _div(body[2], mesh, model))

    if nd == 2:
        if "embed" in path_s:
            if embed_vocab_shard:  # vocab-parallel: V over model, D over fsdp
                return leading + (_div(body[0], mesh, model),
                                  _div(body[1], mesh, fsdp))
            return leading + (_div(body[0], mesh, fsdp),
                              _div(body[1], mesh, model))
        if "head" in path_s:       # logits dim V over model, either way
            return leading + (_div(body[0], mesh, fsdp),
                              _div(body[1], mesh, model))
        if name in _OUT_PROJ:
            return leading + (_div(body[0], mesh, model),
                              _div(body[1], mesh, fsdp))
        return leading + (_div(body[0], mesh, fsdp),
                          _div(body[1], mesh, model))

    return leading + (None,) * nd


def _is_unrolled(path_s: str) -> bool:
    # unrolled (hybrid) layers look like "layers/0/..." — numeric second part
    parts = path_s.split("/")
    return len(parts) > 1 and parts[1].isdigit()


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_pspecs(params_shapes: Mapping[str, object], mesh, *,
                 fsdp: Optional[str], model: str,
                 worker_axes: Tuple[str, ...] = (),
                 embed_vocab_shard: bool = False) -> Dict[str, Spec]:
    """``{key: spec}`` for a flat parameter dict (tensors, meta tensors or
    shapes).  ``worker_axes`` non-empty → the leaves carry a leading
    worker-stack dim, sharded over those axes (decentralized training
    state)."""
    specs = {}
    for key, leaf in params_shapes.items():
        ps = path_of(key)
        stacked = ps.startswith("layers/") and not _is_unrolled(ps)
        shape = _shape(leaf)
        if worker_axes:
            shape = shape[1:]
        spec = leaf_spec(ps, shape, mesh, fsdp, model, stacked,
                         embed_vocab_shard=embed_vocab_shard)
        if worker_axes:
            spec = (worker_axes if len(worker_axes) > 1 else worker_axes[0],
                    ) + spec
        specs[key] = spec
    return specs


def batch_pspec(batch_shapes: Mapping[str, object],
                worker_axes: Tuple[str, ...], fsdp: Optional[str],
                seq_axis: Optional[str] = None) -> Dict[str, Spec]:
    """Specs for a train batch shaped (n_workers, per_worker_batch, S, ...).

    Worker-stack dim over ``worker_axes``; per-worker batch over ``fsdp``;
    sequence dim optionally over ``seq_axis`` (sequence parallelism).
    """
    first = worker_axes if len(worker_axes) > 1 else worker_axes[0]

    def spec(leaf):
        nd = len(_shape(leaf))
        rest = [fsdp, seq_axis] + [None] * max(0, nd - 3)
        return (first,) + tuple(rest[: nd - 1])

    return {k: spec(v) for k, v in batch_shapes.items()}


def serve_batch_dim(shape: Sequence[int]) -> int:
    """The dim ``serve_pspecs`` takes for the batch: 1 behind a leading
    stacked-layer axis ((L, B, ...) with L ≤ 256 and nd ≥ 3), else 0."""
    nd = len(shape)
    return 1 if nd >= 3 and shape[0] <= 256 else 0


def state_map(fn, state):
    """``fn`` over every tensor leaf of a decode state (a tuple of per-layer
    states, or one layer-stacked state: ``KVCache``, ``RGLRUState``,
    ``RWKVState``), the structure kept."""
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        return type(state)(state_map(fn, s) for s in state)
    if hasattr(state, "_fields"):                    # NamedTuple states
        return type(state)(*(fn(x) for x in state))
    fields = ("k", "v", "positions")                 # layers.KVCache
    return type(state)(**{f: fn(getattr(state, f)) for f in fields})


def state_leaves(state):
    """The tensor leaves of a decode state, in ``state_map``'s order."""
    out = []
    state_map(lambda x: out.append(x) or x, state)
    return out


def serve_pspecs(state_shapes, mesh, *, data="data", model: str = "model"):
    """Specs for decode state: batch over data, the largest other dim over
    model where it divides.  Same structure as ``state_shapes``."""
    def spec(leaf):
        shape = _shape(leaf)
        out = [None] * len(shape)
        b_idx = serve_batch_dim(shape)
        if len(shape) > b_idx:
            out[b_idx] = _div(shape[b_idx], mesh, data)
        # shard the largest remaining dim over model if divisible
        rest = [(i, s) for i, s in enumerate(shape) if i > b_idx]
        rest.sort(key=lambda t: -t[1])
        for i, s in rest:
            ax = _div(s, mesh, model)
            if ax:
                out[i] = ax
                break
        return tuple(out)

    return state_map(spec, state_shapes)


# ---------------------------------------------------------------------------
# DTensor placements and shard shapes
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names that axis (a tuple of names
    shards d on each of them, in mesh order, the first the major, as the
    reference's ``P(("pod", "data"))``), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"axis {axis!r} shards two dims of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and a not in mesh.mesh_dim_names:
                raise ValueError(f"{spec} names {a!r}, not an axis of "
                                 f"{mesh.mesh_dim_names}")
    return tuple(out)


def local_shard(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds whole (no
    communication): each ``Shard(d)`` of ``place`` chunks dim d by its mesh
    dim's size at this rank's coordinate, in mesh order, as a DTensor lays
    it out.  A view of ``full``."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(place):
        if p.is_shard():
            out = out.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard (every named axis divides its dim, as
    the policy's fallback guarantees)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in (e if isinstance(e, tuple) else (e,)):
            n *= sizes[a] if a is not None else 1
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {e} ({n})")
        out.append(dim // n)
    return tuple(out)


def nbytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize
