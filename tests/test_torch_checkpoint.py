"""The port's checkpoint manager (``repro_torch.checkpoint``) vs the JAX
package's, on the CPU.

A checkpoint written by either package restores in the other with equal
arrays (compared exactly, bfloat16 bits included) and an equal ``extra``;
both write the same ``manifest.json`` bytes and the same array-file bytes
for the same tree, under zlib (the codec where ``zstandard`` is missing)
and, where ``zstandard`` is installed, under zstd.  The port's own
behaviour follows ``tests/test_substrate.py``'s checks of the reference:
``keep`` GC, ``async_save`` and the atomic ``LATEST`` pointer.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jman
import repro_torch.checkpoint.manager as tman

SEED = 20240527
EXTRA = {"step": 3, "pipeline": {"step": 4}}


def _pair():
    """The same leaves as a reference tree (numpy / ml_dtypes bfloat16) and
    a port tree (tensors): float32 matrices, an int32 scalar, bfloat16
    vectors (one of them empty) and a list."""
    rng = np.random.default_rng(SEED)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b16 = torch.from_numpy(rng.standard_normal(7).astype(np.float32)).to(torch.bfloat16)
    bits = b16.view(torch.int16).numpy()
    layers = [rng.standard_normal((2, 2)).astype(np.float32) for _ in range(2)]
    ref = {
        "params": {"w": w, "norm": {"g": bits.view(ml_dtypes.bfloat16)},
                   "empty": np.zeros(0, ml_dtypes.bfloat16), "layers": layers},
        "opt": {"step": np.asarray(9, np.int32)},
    }
    port = {
        "params": {"w": torch.from_numpy(w.copy()), "norm": {"g": b16},
                   "empty": torch.zeros(0, dtype=torch.bfloat16),
                   "layers": [torch.from_numpy(a.copy()) for a in layers]},
        "opt": {"step": torch.tensor(9, dtype=torch.int32)},
    }
    return ref, port


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        return _flat({str(i): v for i, v in enumerate(tree)}, prefix)
    return {prefix[:-1]: tree}


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return str(x.dtype), tuple(x.shape), np.ascontiguousarray(x).tobytes()


def _same_trees(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


def test_port_checkpoint_restores_in_reference(tmp_path):
    ref, port = _pair()
    tman.CheckpointManager(str(tmp_path)).save(3, port, extra=EXTRA)
    got, extra = jman.CheckpointManager(str(tmp_path)).restore()
    assert extra == EXTRA
    assert got["params"]["norm"]["g"].dtype == jnp.bfloat16
    _same_trees(got, {**ref, "params": {**ref["params"], "layers": {
        str(i): a for i, a in enumerate(ref["params"]["layers"])}}})


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref, port = _pair()
    jman.CheckpointManager(str(tmp_path)).save(3, ref, extra=EXTRA)
    got, extra = tman.CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert extra == EXTRA
    assert got["params"]["norm"]["g"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].shape == ()
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in _flat(got).values())
    _same_trees(got, {**port, "params": {**port["params"], "layers": {
        str(i): a for i, a in enumerate(port["params"]["layers"])}}})


def _codecs():
    out = ["zlib"]
    if tman.zstd is not None and jman.zstd is not None:
        out.append("zstd")
    return out


@pytest.mark.parametrize("codec", _codecs())
def test_both_packages_write_the_same_bytes(tmp_path, monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(jman, "zstd", None)
        monkeypatch.setattr(tman, "zstd", None)
    ref, port = _pair()
    jman.CheckpointManager(str(tmp_path / "ref")).save(12, ref, extra=EXTRA)
    tman.CheckpointManager(str(tmp_path / "port")).save(12, port, extra=EXTRA)
    ext = {"zlib": "zlib", "zstd": "zst"}[codec]
    for name in ("manifest.json", f"arrays.bin.{ext}"):
        want = (tmp_path / "ref" / "step_00000012" / name).read_bytes()
        assert (tmp_path / "port" / "step_00000012" / name).read_bytes() == want, name
    manifest = json.loads((tmp_path / "port" / "step_00000012" / "manifest.json").read_text())
    assert manifest["codec"] == codec
    assert (tmp_path / "port" / "LATEST").read_text() == "step_00000012"


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"step": step})
    assert mgr.latest_step() == 3
    got, extra = mgr.restore(device="cpu")
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16 and torch.equal(got["b"]["c"], tree["b"]["c"])
    assert extra["step"] == 3
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000002", "step_00000003"]  # keep=2 collected step 1
    older, _ = mgr.restore(step=2, device="cpu")
    assert torch.equal(older["a"], tree["a"])


def test_checkpoint_async_and_pointer_atomicity(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.zeros(3)
    mgr.save(5, {"x": x}, extra={"step": 5})
    x.add_(1.0)  # the save gathered its own copy before returning
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    got, _ = mgr.restore(device="cpu")
    assert torch.equal(got["x"], torch.zeros(3))


def test_stale_tmp_and_dangling_pointer(tmp_path):
    """A crash mid-save leaves a ``.tmp`` directory: it is never read,
    GC'd or pointed at; a pointer to a missing directory reads as none."""
    mgr = tman.CheckpointManager(str(tmp_path), keep=1)
    assert mgr.latest_step() is None and mgr.restore(device="cpu") == (None, None)
    os.makedirs(tmp_path / "step_00000009.tmp")
    mgr.save(1, {"x": torch.ones(2)})
    mgr.save(9, {"x": torch.full((2,), 2.0)})
    assert mgr.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000009"]
    (tmp_path / "LATEST").write_text("step_00000042")
    assert mgr.latest_step() is None


def test_restore_on_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is available: device='cuda' is valid")
    mgr = tman.CheckpointManager(str(tmp_path))
    mgr.save(0, {"x": torch.ones(1)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.restore()
