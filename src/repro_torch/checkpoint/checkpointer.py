"""Checkpoints of flat parameter dicts, in the reference's file format.

The port of ``repro/checkpoint/checkpointer.py``: one npz file per step,
``ckpt_{step:08d}.npz``, holding every leaf under the reference's pytree
path joined by ``/`` (``layers/0/rec/w_in``; the port's flat keys join the
same path by ``.``, ``models/convert.py``) and ``__meta__``, a JSON string
with ``step``, ``dtypes`` and ``extra`` (the data pipeline's cursor, say).
npz has no bfloat16, so a bf16 leaf is stored as its raw bytes (uint8 of
shape ``shape + (2,)``) with ``"bfloat16"`` recorded in ``dtypes``; that
is how ``ml_dtypes`` lays the reference's bf16 out too, so a file written
by either package restores bit-exactly in the other.  Writes are atomic
(a temporary file, then ``os.replace``) and keep the last ``keep`` steps.
Supports the stacked (N, ...) worker state and a single worker's slice of
it, as a deployment writes per host.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]

# dtypes numpy stores as they are (the reference's ``_NATIVE_DTYPES`` that
# torch has)
_NATIVE = {torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
           torch.int64, torch.float16, torch.float32, torch.float64,
           torch.complex64, torch.complex128}


def file_key(key: str) -> str:
    """The file's key of a flat key: ``layers.0.rec.w_in`` → ``layers/0/rec/w_in``."""
    return key.replace(".", "/")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """The array npz stores for ``t``, and the dtype name to record when it
    is raw bytes (bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _NATIVE:
        return t.numpy(), None
    if t.dtype != torch.bfloat16:
        raise TypeError(f"cannot checkpoint dtype {t.dtype}")
    raw = t.view(torch.int16).numpy().view(np.uint8)
    return raw.reshape(tuple(t.shape) + (2,)), "bfloat16"


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """The tensor of a stored array (bf16 from its raw bytes, viewed as
    int16 then bfloat16: no ``ml_dtypes`` needed)."""
    if dtype_name is None:
        return torch.from_numpy(np.array(arr))
    if dtype_name != "bfloat16":
        raise TypeError(f"cannot restore dtype {dtype_name!r}")
    bits = np.ascontiguousarray(arr).view(np.int16).reshape(arr.shape[:-1])
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None) -> str:
        """Write ``tree`` (a flat dict) as step ``step``; returns the path."""
        flat, dtypes = {}, {}
        for k, t in tree.items():
            fk = file_key(k)
            flat[fk], name = _to_numpy(t)
            if name is not None:
                dtypes[fk] = name
        meta = {"step": step, "dtypes": dtypes, "extra": extra or {}}
        path = self._path(step)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".npz")
        os.close(fd)
        np.savez(tmp, __meta__=json.dumps(meta, default=_json_default), **flat)
        os.replace(tmp, path)  # atomic publish
        self._gc()
        return path

    def _read(self, keys: Dict[str, str], step: Optional[int]):
        """({flat key: tensor} of the file keys ``keys`` maps to, meta) of
        step ``step`` (the latest when None)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with np.load(self._path(step), allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            dtypes = meta.get("dtypes", {})
            missing = [fk for fk in keys.values() if fk not in data]
            if missing:
                raise KeyError(f"checkpoint missing leaf {missing[0]}")
            return ({k: _from_numpy(data[fk], dtypes.get(fk))
                     for k, fk in keys.items()}, meta)

    def restore(self, like: Tree, step: Optional[int] = None
                ) -> Tuple[Tree, Dict]:
        """(tree, extra): the leaves of ``like``'s keys, each of its shape
        (a mismatch raises), cast to its dtype and put on its device."""
        got, meta = self._read({k: file_key(k) for k in like}, step)
        for k, leaf in like.items():
            if tuple(got[k].shape) != tuple(leaf.shape):
                raise ValueError(f"{file_key(k)}: shape {tuple(got[k].shape)}"
                                 f" != {tuple(leaf.shape)}")
        return ({k: got[k].to(device=leaf.device, dtype=leaf.dtype)
                 for k, leaf in like.items()}, meta.get("extra", {}))

    def restore_worker_slice(self, like_single: Tree, worker: int,
                             step: Optional[int] = None) -> Tree:
        """One worker's parameters from a stacked (N, ...) checkpoint, in
        the stored dtype, on ``like_single``'s devices."""
        got, _ = self._read({k: file_key(k) for k in like_single}, step)
        return {k: got[k][worker].to(device=leaf.device)
                for k, leaf in like_single.items()}

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(f[5:-4]) for f in os.listdir(self.directory)
                      if f.startswith("ckpt_") and f.endswith(".npz"))

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            os.remove(self._path(s))


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
