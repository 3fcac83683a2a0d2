"""Production meshes and hierarchical worker views on ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  ``make_production_mesh`` builds the
reference's mandated topology as a ``DeviceMesh``: 16×16 = 256 ranks a
pod, 2 pods = 512 ranks multi-pod.  Decentralized training uses a derived
view of the same ranks: the ``data`` axis splits into (worker × fsdp), so
that giant architectures keep fewer replicas, each sharded over its own
ranks.  Functions only: importing this module creates no process group.

Every function here needs the default process group, created first
(``torch.distributed.init_process_group``; the dry run uses the fake one,
``launch/dryrun.py``).  On one card, with no process group, the workers
are a stacked leading axis instead (``launch/steps.py:build_train_step``),
and only ``MICROBATCH`` is read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or the mapping itself (a
    mesh's ``.shape`` as the reference's tests fake it)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


@dataclasses.dataclass(frozen=True)
class TrainAxes:
    """Axis names of the (possibly hierarchical) training mesh view."""
    pod: Optional[str]      # "pod" on the multi-pod mesh, else None
    worker: str             # gossip axis
    fsdp: Optional[str]     # intra-worker parameter sharding, None if f == 1
    model: str              # tensor/expert parallel

    @property
    def worker_axes(self) -> Tuple[str, ...]:
        return ((self.pod,) if self.pod else ()) + (self.worker,)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        out = self.worker_axes
        return out + ((self.fsdp,) if self.fsdp else ())


def _split_axis(mesh: DeviceMesh, axis: str, sizes: Tuple[int, ...],
                names: Tuple[str, ...]) -> DeviceMesh:
    """``mesh`` with ``axis`` split into ``names`` of ``sizes`` (row-major,
    the same ranks).  The one use of ``DeviceMesh._unflatten``, a private
    method; a torch without it gets a ``DeviceMesh`` built from the
    reshaped rank tensor (which creates the new axes' groups itself)."""
    dim = mesh.mesh_dim_names.index(axis)
    if hasattr(DeviceMesh, "_unflatten"):
        return mesh._unflatten(dim, sizes, names)
    ranks = mesh.mesh.reshape(tuple(mesh.mesh.shape[:dim]) + tuple(sizes)
                              + tuple(mesh.mesh.shape[dim + 1:]))
    new_names = (mesh.mesh_dim_names[:dim] + tuple(names)
                 + mesh.mesh_dim_names[dim + 1:])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=new_names)


def hierarchical_view(mesh: DeviceMesh, workers: int,
                      fsdp: int) -> Tuple[DeviceMesh, TrainAxes]:
    """Split the mesh's ``data`` axis into (worker, fsdp): the same ranks,
    the ``fsdp`` axis dropped when it is 1.

    The rank layout is exactly the production mesh's; only the axis naming
    changes, so every dry run still runs on the mandated 16×16 / 2×16×16
    topology.
    """
    names = mesh.mesh_dim_names
    data_size = axis_sizes(mesh)["data"]
    if workers * fsdp != data_size:
        raise ValueError(f"workers*fsdp must equal data axis ({data_size}), "
                         f"got {workers}×{fsdp}")
    if fsdp > 1:
        view = _split_axis(mesh, "data", (workers, fsdp), ("worker", "fsdp"))
    else:
        view = _split_axis(mesh, "data", (workers,), ("worker",))
    axes = TrainAxes(pod="pod" if "pod" in names else None, worker="worker",
                     fsdp="fsdp" if fsdp > 1 else None, model="model")
    return view, axes


# Per-architecture (workers, fsdp) split of the 16-wide data axis, the
# reference's values unchanged: it sized them so that a worker replica
# (params + grads + remat'd activations) fits one of its 16 GB TPU v5e chips.
WORKER_FSDP: Dict[str, Tuple[int, int]] = {
    "deepseek-67b": (4, 4),
    "rwkv6-1.6b": (16, 1),
    "minicpm-2b": (16, 1),
    "musicgen-large": (16, 1),
    "grok-1-314b": (2, 8),
    "mistral-nemo-12b": (16, 1),
    "arctic-480b": (2, 8),
    "llava-next-mistral-7b": (16, 1),
    "recurrentgemma-2b": (16, 1),
    "qwen3-8b": (16, 1),
}

# Gradient-accumulation microbatches for activation-heavy train configs.
MICROBATCH: Dict[str, int] = {
    "deepseek-67b": 2,
    "grok-1-314b": 2,
    # arctic: the reference measured float32 accumulation buffers costing
    # more than microbatching saves; a single batch + remat is better.
}


def train_view(arch: str, *, multi_pod: bool = False,
               device_type: str = "cuda") -> Tuple[DeviceMesh, TrainAxes, int]:
    """(mesh view, axes, total workers) of an arch's production training."""
    w, f = WORKER_FSDP.get(arch, (16, 1))
    base = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    view, axes = hierarchical_view(base, w, f)
    n_workers = w * (2 if multi_pod else 1)
    return view, axes, n_workers
