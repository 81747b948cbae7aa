"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's (``tests/test_checkpoint_faults.py``): round trip, keep-N GC,
async save then wait, a writer killed at any file or between COMMIT and
the rename never tears a snapshot, a background failure is raised once,
discovery trusts only committed ``step_<N>`` directories; and the two
packages read each other's checkpoints of the smoke params, bf16 and
fp32, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models import model as JM
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as C
from repro_torch.models import bridge

from _torch_common import cfg_pair

torch.set_num_threads(1)


def _tree(k=0):
    return {"a": torch.arange(12.0).reshape(3, 4) + k,
            "b": {"c": torch.ones((5,), dtype=torch.int32) * k}}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree(3)
    ck.save(7, t, block=True)
    assert ck.all_steps() == [7]
    step, got = ck.restore_latest(_tree(0))
    assert step == 7
    assert torch.equal(got["a"], t["a"])
    assert torch.equal(got["b"]["c"], t["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32


def test_checkpoint_gc_keeps_last(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), block=True)
    assert ck.all_steps() == [3, 4]


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))       # async
    ck.wait()
    assert ck.latest_step() == 1


def _crashing_put(fail_at):
    """A ``_put`` that dies on its ``fail_at``-th file write."""
    calls = {"n": 0}
    orig = Checkpointer._put

    def put(path, writer):
        if calls["n"] == fail_at:
            raise RuntimeError("simulated disk death")
        calls["n"] += 1
        orig(path, writer)
    return put


@pytest.mark.parametrize("fail_at", [0, 1, 2, 3])
def test_mid_write_crash_never_tears_snapshot(tmp_path, fail_at):
    # a step writes 2 leaves + manifest + COMMIT = 4 files; failing at
    # each index is a writer dying in the leaves, the manifest or COMMIT
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), block=True)
    ck._put = _crashing_put(fail_at)
    ck.save(2, _tree(2))
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ck.wait()
    assert ck.all_steps() == [1]          # the torn write is invisible
    step, got = ck.restore_latest(_tree(0))
    assert step == 1
    assert torch.equal(got["a"], _tree(1)["a"])
    del ck._put                           # the disk recovers
    ck.save(2, _tree(2), block=True)      # clobbers the leftover .tmp
    assert ck.all_steps() == [1, 2]


def test_crash_between_commit_and_rename(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), block=True)
    orig = C.os.replace

    def replace(src, dst):
        if src.endswith(".tmp"):          # the final directory rename
            raise RuntimeError("killed before rename")
        orig(src, dst)
    monkeypatch.setattr(C.os, "replace", replace)
    ck.save(2, _tree(2))
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ck.wait()
    # the .tmp dir carries COMMIT, yet discovery must not trust it
    assert os.path.exists(
        os.path.join(str(tmp_path), "step_00000002.tmp", "COMMIT"))
    assert ck.all_steps() == [1]
    monkeypatch.undo()
    ck.save(2, _tree(2), block=True)
    assert ck.all_steps() == [1, 2]


def test_wait_reraises_and_clears_background_failure(tmp_path):
    ck = Checkpointer(str(tmp_path))

    def boom(step, leaves, treedef):
        raise ValueError("flaky filesystem")
    ck._write = boom
    ck.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="background checkpoint") as ei:
        ck.wait()
    assert isinstance(ei.value.__cause__, ValueError)
    ck.wait()                             # consumed, not sticky


def test_discovery_ignores_non_snapshot_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(3), block=True)
    for name in ("step_abc", "step_00000004.tmp", "stepX"):
        os.makedirs(os.path.join(str(tmp_path), name))
        with open(os.path.join(str(tmp_path), name, "COMMIT"), "wb") as f:
            f.write(b"ok")
    os.makedirs(os.path.join(str(tmp_path), "step_00000005"))  # no COMMIT
    assert ck.all_steps() == [3]


def test_flatten_is_jax_tree_order():
    """Leaves in jax.tree.flatten's order and its treedef string, so that
    leaf_<i>.npy names the same leaf in both packages."""
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": 5}}
    leaves, treedef = C.flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves and treedef == str(jdef)
    assert C.unflatten(tree, leaves) == tree


def _smoke(dtype):
    cj, ct = cfg_pair(dtype, "yi-9b")
    pj = JM.init_params(cj, jax.random.PRNGKey(4))
    return cj, ct, pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                              ct, device="cpu")


def _pairs(tj, tt):
    lj, _ = jax.tree.flatten(tj)
    lt, _ = C.flatten(tt)
    assert len(lj) == len(lt) > 0
    return zip(lj, lt)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """A JAX-written checkpoint of the smoke params restores in the port
    and equals, bit for bit, the live params bridged through
    ``models/bridge.py``."""
    _, _, pj, pt = _smoke(dtype)
    JCheckpointer(str(tmp_path)).save(5, {"params": pj}, block=True)
    step, got = Checkpointer(str(tmp_path)).restore_latest({"params": pt})
    assert step == 5
    la, _ = C.flatten(got)
    lb, _ = C.flatten({"params": pt})
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    """A port-written checkpoint (bf16 as a uint16 view under the name
    ``bfloat16``) restores in the JAX package's Checkpointer, bit for bit
    equal to JAX's own params."""
    _, _, pj, pt = _smoke(dtype)
    Checkpointer(str(tmp_path)).save(6, {"params": pt}, block=True)
    step, got = JCheckpointer(str(tmp_path)).restore_latest({"params": pj})
    assert step == 6
    for a, b in _pairs(got, {"params": pj}):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(jnp.array_equal(a.view(jnp.uint16) if a.dtype ==
                                    jnp.bfloat16 else a,
                                    b.view(jnp.uint16) if b.dtype ==
                                    jnp.bfloat16 else b))
