"""The port's checkpoint manager, with the cases of tests/test_checkpoint.py:
roundtrip (bf16 bit-exact), async save and wait, retention, partial
checkpoints ignored, a mismatched target rejected, overwrite of a step."""
import json

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adamw import OptState

torch.set_num_threads(1)


def state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.randn(3, generator=g).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "blocks": [{"w": torch.randn(2, 2, generator=g)}],
            "opt": OptState(step=torch.tensor(3, dtype=torch.int32),
                            mu={"x": torch.randn(5, generator=g)},
                            nu={"x": torch.rand(5, generator=g)})}


def zeros_like(t):
    return tree.tree_map(torch.zeros_like, t)


def assert_state_equal(x, y):
    for (pa, a), (pb, b) in zip(tree.flatten_with_paths(x),
                                tree.flatten_with_paths(y), strict=True):
        assert pa == pb
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        assert torch.equal(a, b), pa


def test_roundtrip_bitwise_with_bf16(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    t = state()
    m.save(10, t, blocking=True)
    assert m.latest_step() == 10
    got = m.restore(10, like=zeros_like(t))
    assert_state_equal(t, got)
    assert isinstance(got["opt"], OptState)
    manifest = json.loads((tmp_path / "step_00000010" /
                           "manifest.json").read_text())
    assert "b/c" in manifest["paths"] and "opt/mu/x" in manifest["paths"]
    assert manifest["dtypes"][manifest["paths"].index("b/c")] == "bfloat16"


def test_save_copies_before_later_in_place_updates(tmp_path):
    """An async save must hold the values at save time, although training
    updates the same tensors in place right after."""
    m = CheckpointManager(tmp_path, keep=3)
    t = state()
    want = tree.tree_map(torch.clone, t)
    m.save(1, t)
    for leaf in tree.leaves(t):
        leaf.add_(1)
    m.wait()
    assert_state_equal(want, m.restore(1, like=zeros_like(t)))


def test_async_save_and_wait(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    for s in (1, 2, 3):
        m.save(s, state(s))
    m.wait()
    assert m.all_steps() == [1, 2, 3]
    assert_state_equal(state(2), m.restore(2, like=zeros_like(state())))


def test_retention_gc(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, state(s), blocking=True)
    assert m.all_steps() == [3, 4]


def test_partial_checkpoint_ignored(tmp_path):
    """A crash mid-write must not poison resume: directories without a
    manifest and .tmp directories are invisible."""
    m = CheckpointManager(tmp_path, keep=3)
    m.save(5, state(), blocking=True)
    (tmp_path / "step_00000009.tmp").mkdir()
    broken = tmp_path / "step_00000007"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    assert m.latest_step() == 5


@pytest.mark.parametrize("change", ["shape", "structure"])
def test_mismatched_target_rejected(tmp_path, change):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(5, state(), blocking=True)
    bad = zeros_like(state())
    if change == "shape":
        bad["a"] = torch.zeros(2, 2)
    else:
        bad["extra"] = torch.zeros(1)
    with pytest.raises(ValueError):
        m.restore(5, like=bad)


def test_overwrite_same_step(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, state(0), blocking=True)
    m.save(1, state(1), blocking=True)
    assert_state_equal(state(1), m.restore(1, like=zeros_like(state(0))))


def test_failed_async_write_surfaces_on_wait(tmp_path):
    m = CheckpointManager(tmp_path / "root", keep=3)
    (tmp_path / "root").rmdir()
    (tmp_path / "root").write_text("not a directory")
    m.save(1, state())
    with pytest.raises(OSError):
        m.wait()


def test_restore_casts_to_the_target_dtype(tmp_path):
    m = CheckpointManager(tmp_path, keep=1)
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    m.save(1, t, blocking=True)
    got = m.restore(1, like={"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), t["w"].numpy())
