"""The port's checkpointer against the JAX package's, on the CPU.

A checkpoint written by either package restores bit-exactly in the other,
bfloat16 leaves (stored as raw bytes) and ``extra`` included; the port
maps its ``.``-joined flat keys to the reference's ``/``-joined pytree
paths.  Also the history bound (``keep``), one worker's slice of a
stacked checkpoint, the errors, and that the port reads bfloat16 without
``ml_dtypes``.
"""
import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_module

EXTRA = {"stream": {"cursor": [3, 1]}, "note": "x", "eta": 0.05}


def _port_tree(seed=0):
    """A stacked (N = 3) flat dict of the hybrid family's key shapes."""
    g = torch.Generator().manual_seed(seed)
    return {
        "embed.table": torch.randn(3, 11, 4, generator=g).to(torch.bfloat16),
        "layers.0.rec.w_in": torch.randn(3, 4, 5, generator=g),
        "layers.1.attn.wq": torch.randn(3, 4, 6, generator=g).to(torch.bfloat16),
        "final_norm.scale": torch.randn(3, 4, generator=g),
        "count": torch.arange(3, dtype=torch.int32),
    }


def _jax_like(tree):
    """The reference's pytree for the port's flat keys (layers a tuple)."""
    def z(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.dtype(
            str(t.dtype).removeprefix("torch."))
        return jnp.zeros(tuple(t.shape), dt)
    return {"embed": {"table": z(tree["embed.table"])},
            "layers": ({"rec": {"w_in": z(tree["layers.0.rec.w_in"])}},
                       {"attn": {"wq": z(tree["layers.1.attn.wq"])}}),
            "final_norm": {"scale": z(tree["final_norm.scale"])},
            "count": z(tree["count"])}


def _jax_flat(jtree):
    return {"embed.table": jtree["embed"]["table"],
            "layers.0.rec.w_in": jtree["layers"][0]["rec"]["w_in"],
            "layers.1.attn.wq": jtree["layers"][1]["attn"]["wq"],
            "final_norm.scale": jtree["final_norm"]["scale"],
            "count": jtree["count"]}


def _bits(x):
    """The raw bits of a leaf of either package, as a NumPy array (a
    bfloat16 leaf as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def test_port_checkpoint_restores_bit_exactly_in_the_reference(tmp_path):
    tree = _port_tree()
    path = Checkpointer(str(tmp_path)).save(7, tree, extra=EXTRA)
    assert os.path.basename(path) == "ckpt_00000007.npz"
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007.npz"]  # no temp left
    jtree, extra = JaxCheckpointer(str(tmp_path)).restore(_jax_like(tree))
    assert extra == EXTRA
    for k, v in _jax_flat(jtree).items():
        np.testing.assert_array_equal(_bits(v), _bits(tree[k]))


def test_reference_checkpoint_restores_bit_exactly_in_the_port(tmp_path):
    tree = _port_tree(1)
    like = _jax_like(tree)
    jtree = {"embed": {"table": jnp.asarray(tree["embed.table"].float().numpy(),
                                            jnp.bfloat16)},
             "layers": ({"rec": {"w_in": jnp.asarray(tree["layers.0.rec.w_in"].numpy())}},
                        {"attn": {"wq": jnp.asarray(tree["layers.1.attn.wq"].float().numpy(),
                                                    jnp.bfloat16)}}),
             "final_norm": {"scale": jnp.asarray(tree["final_norm.scale"].numpy())},
             "count": jnp.asarray(tree["count"].numpy())}
    assert jax.tree.structure(jtree) == jax.tree.structure(like)
    JaxCheckpointer(str(tmp_path)).save(3, jtree, extra=EXTRA)
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, extra = Checkpointer(str(tmp_path)).restore(zeros)
    assert extra == EXTRA
    for k, v in got.items():
        assert v.dtype == tree[k].dtype
        np.testing.assert_array_equal(_bits(v), _bits(tree[k]))


def test_history_is_bounded_and_latest_is_restored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    for step in range(1, 6):
        ck.save(step, {"w": torch.full((2,), float(step))})
    assert ck.all_steps() == [3, 4, 5] and ck.latest_step() == 5
    got, extra = ck.restore({"w": torch.zeros(2)})
    assert got["w"].tolist() == [5.0, 5.0] and extra == {}
    got, _ = ck.restore({"w": torch.zeros(2)}, step=3)
    assert got["w"].tolist() == [3.0, 3.0]
    assert JaxCheckpointer(str(tmp_path)).all_steps() == [3, 4, 5]


def test_worker_slice_of_a_stacked_checkpoint(tmp_path):
    tree = _port_tree(2)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    one = ck.restore_worker_slice({k: v[0] for k, v in tree.items()}, 2)
    for k, v in one.items():
        assert v.dtype == tree[k].dtype
        np.testing.assert_array_equal(_bits(v), _bits(tree[k][2].contiguous()))
    jone = JaxCheckpointer(str(tmp_path)).restore_worker_slice(
        _jax_like({k: v[0] for k, v in tree.items()}), 2)
    for k, v in _jax_flat(jone).items():
        np.testing.assert_array_equal(_bits(v), _bits(one[k]))


def test_errors(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)})
    ck.save(1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing leaf v"):
        ck.restore({"v": torch.zeros(2, 3)})


def test_bfloat16_needs_no_ml_dtypes():
    src = Path(ckpt_module.__file__).read_text(encoding="utf-8")
    names = {a.name.split(".")[0] for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Import) for a in node.names}
    names |= {(node.module or "").split(".")[0] for node in ast.walk(ast.parse(src))
              if isinstance(node, ast.ImportFrom)}
    assert "ml_dtypes" not in names
