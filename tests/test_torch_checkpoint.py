"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's: the same layout on disk, both cross reads bit for bit (a
tree written by ``repro.checkpoint.save_checkpoint`` restores in the
port, and the port's write restores in the reference), and the
reference's own tests (``tests/substrate/test_checkpoint.py``) on the
port."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as R
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(8, 16)).astype(np.float32),
        "nested": {"b": rng.normal(size=(16,)).astype(np.float32), "a": rng.integers(0, 9, (3,)).astype(np.int32)},
        "step_count": np.asarray(7, np.int32),
    }


def _tree(seed=0):
    """The port's twin of the reference test's tree: f32, bf16, int32."""
    t = _np_tree(seed)
    return {"w": torch.from_numpy(t["w"]),
            "nested": {"b": torch.from_numpy(t["nested"]["b"]).bfloat16(), "a": torch.from_numpy(t["nested"]["a"])},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def _ref_tree(seed=0):
    t = _np_tree(seed)
    return {"w": jnp.asarray(t["w"]),
            "nested": {"b": jnp.asarray(t["nested"]["b"], jnp.bfloat16), "a": jnp.asarray(t["nested"]["a"])},
            "step_count": jnp.asarray(7, jnp.int32)}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a).tobytes()


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda x: x, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                           is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_reference_write_restores_bit_equal_in_the_port(tmp_path):
    R.save_checkpoint(tmp_path, 4, (_ref_tree(1), [_ref_tree(2)["w"]]))
    restored, step = restore_checkpoint(tmp_path, (_tree(), [torch.zeros(8, 16)]))
    assert step == 4
    want = jax.tree.leaves((_ref_tree(1), [_ref_tree(2)["w"]]))
    got = _leaves(restored)
    assert len(got) == len(want)
    assert restored[0]["nested"]["b"].dtype == torch.bfloat16
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)


def test_port_write_restores_bit_equal_in_the_reference(tmp_path):
    save_checkpoint(tmp_path, 9, (_tree(3), [_tree(4)["nested"]["b"]]), extra={"note": 1})
    like = (_ref_tree(), [_ref_tree()["nested"]["b"]])
    restored, step = R.restore_checkpoint(tmp_path, like)
    assert step == 9
    got = jax.tree.leaves(restored)
    want = _leaves((_tree(3), [_tree(4)["nested"]["b"]]))
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)
    assert np.asarray(restored[0]["nested"]["b"]).dtype == ml_dtypes.bfloat16


def test_same_manifest_as_the_reference(tmp_path):
    R.save_checkpoint(tmp_path / "ref", 2, (_ref_tree(), [_ref_tree()["w"]]))
    save_checkpoint(tmp_path / "port", 2, (_tree(), [_tree()["w"]]))
    a = json.loads((tmp_path / "ref" / "step_00000002" / "manifest.json").read_text())
    b = json.loads((tmp_path / "port" / "step_00000002" / "manifest.json").read_text())
    assert a == b
    with np.load(tmp_path / "ref" / "step_00000002" / "arrays.npz") as ra, \
            np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as pa:
        assert sorted(ra.files) == sorted(pa.files)
        for f in ra.files:
            assert ra[f].dtype == pa[f].dtype and ra[f].tobytes() == pa[f].tobytes()
    assert sorted(p.name for p in (tmp_path / "port" / "step_00000002").iterdir()) == \
        ["COMMIT", "arrays.npz", "manifest.json"]


def test_restore_onto_a_device_and_into_the_like_types(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    like = _tree()
    like["w"] = like["w"].double()
    restored, _ = restore_checkpoint(tmp_path, like, device="cpu")
    assert restored["w"].dtype == torch.float64 and restored["w"].device.type == "cpu"
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_restore_rejects_another_tree(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(1)})


def test_manager_snapshots_before_writing(tmp_path):
    """The tree is copied to the host when save_async is called: changing
    it afterwards does not change what is written."""
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save_async(1, t)
    t["w"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(_tree())
    assert torch.equal(restored["w"], _tree()["w"])


def test_manager_surfaces_a_writer_error(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    mgr = CheckpointManager(tmp_path / "file", keep=1)
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()      # the error is raised once


# -- tests/substrate/test_checkpoint.py on the port

def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 10, tree)
    restored, step = restore_checkpoint(tmp_path, tree)
    assert step == 10
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_committed_wins(tmp_path):
    save_checkpoint(tmp_path, 1, _tree(1))
    save_checkpoint(tmp_path, 5, _tree(5))
    _, step = restore_checkpoint(tmp_path, _tree())
    assert step == 5


def test_torn_checkpoint_ignored(tmp_path):
    save_checkpoint(tmp_path, 1, _tree(1))
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")
    _, step = restore_checkpoint(tmp_path, _tree())
    assert step == 1


def test_async_manager_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    assert mgr.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps == [3, 4]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "nope", _tree())
