"""Fault-tolerant checkpointing: atomic, versioned, compressed.

The port of ``repro.checkpoint.manager``, with its layout, manifest and
codec, so a checkpoint written by either package restores in the other::

    <root>/step_00000420/manifest.json     # tree structure + dtypes/shapes + codec
    <root>/step_00000420/arrays.bin.zst    # concatenated raw buffers (or .zlib)
    <root>/LATEST                          # atomic pointer file

Writes go to ``<dir>.tmp`` then ``os.replace``: a crash mid-save can never
corrupt the pointer or a previous checkpoint.  A tree's leaves are
tensors (on any device; gathered to the host at ``save``), numpy arrays
or numbers.  ``restore(device=...)`` returns tensors on that device, and
``restore(shardings=...)`` lays the leaves it names on a mesh, as
``DTensor``s, for elastic restarts on another mesh.

Under ``torch.distributed`` every rank calls ``save`` and the manager
decides: only global rank 0 writes.  A ``DTensor`` leaf is gathered with
``collectives.gather_full``, a collective, on every rank (``torch.distributed``'s
own all-gathers, which a ``gloo`` group runs on CUDA tensors too); other
leaves are read on rank 0 alone.  The caller puts a barrier between a save and a restore on
other ranks.  ``restore`` reads
the files on every rank that calls it.

The codec is ``zstandard`` when installed, stdlib ``zlib`` otherwise; the
manifest records it.  bfloat16 leaves (numpy has none without
``ml_dtypes``, which the port does not need) are written as their raw
bytes under the dtype string ``"bfloat16"``, as the reference writes them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.collectives import gather_full
from ..kernels.ops import resolve_device

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover - depends on environment
    zstd = None

__all__ = ["CheckpointManager"]

_CODEC_EXT = {"zstd": "zst", "zlib": "zlib"}
_BF16 = "bfloat16"


def _default_codec() -> str:
    return "zstd" if zstd is not None else "zlib"


def _compress_stream(codec: str, f, chunks) -> None:
    if codec == "zstd":
        with zstd.ZstdCompressor(level=3).stream_writer(f) as w:
            for c in chunks:
                w.write(c)
    elif codec == "zlib":
        co = zlib.compressobj(6)
        for c in chunks:
            f.write(co.compress(c))
        f.write(co.flush())
    else:
        raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress_bytes(codec: str, f) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not installed"
            )
        return zstd.ZstdDecompressor().stream_reader(f).read()
    if codec == "zlib":
        return zlib.decompress(f.read())
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _to_host(v) -> tuple[str, np.ndarray]:
    """(dtype string, host array whose bytes are the leaf's) of a leaf."""
    if isinstance(v, torch.Tensor):
        v = gather_full(v)  # a DTensor: gathered from its mesh
        t = v.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy().reshape(t.shape)
        a = t.numpy()
    else:
        a = np.array(v)
    return str(a.dtype), a


def _writes() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, extra: dict | None = None) -> str:
        """Save a tree of tensors (gathered to the host first; see the
        module doc for ``DTensor`` leaves and ranks)."""
        flat = _flatten(tree)
        if not _writes():
            for v in flat.values():
                gather_full(v)  # every rank joins a DTensor's gather
            return self._dir(step)
        host = {k: _to_host(v) for k, v in flat.items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {})
            )
            self._thread.start()
            return self._dir(step)
        self._write(step, host, extra or {})
        return self._dir(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _write(self, step: int, host: dict, extra: dict) -> None:
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        codec = _default_codec()
        fn = f"arrays.bin.{_CODEC_EXT[codec]}"
        manifest = {"step": step, "extra": extra, "codec": codec, "file": fn,
                    "arrays": []}
        for k, (dtype, a) in host.items():
            manifest["arrays"].append({"path": k, "dtype": dtype, "shape": list(a.shape)})
        with open(os.path.join(tmp, fn), "wb") as f:
            _compress_stream(
                codec,
                f,
                (np.ascontiguousarray(a).tobytes() for _, a in host.values()),
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # atomic LATEST pointer
        ptr_tmp = os.path.join(self.root, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(ptr_tmp, os.path.join(self.root, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.root) if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def latest_step(self) -> int | None:
        ptr = os.path.join(self.root, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.root, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int | None = None, device="cuda", shardings=None):
        """Load ``(tree, extra)`` with every leaf a tensor on ``device``;
        ``(None, None)`` when there is no checkpoint.  ``shardings``: an
        optional tree of ``distributed.sharding.NamedSharding`` (e.g.
        ``param_sharding``'s) whose leaves are laid on their mesh as
        ``DTensor``s (every rank keeps its own blocks), the others left
        on ``device``."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        # pre-codec checkpoints have no codec/file fields and are always zstd
        codec = manifest.get("codec", "zstd")
        fn = manifest.get("file", "arrays.bin.zst")
        with open(os.path.join(d, fn), "rb") as f:
            raw = _decompress_bytes(codec, f)
        flat = {}
        off = 0
        for rec in manifest["arrays"]:
            shape = rec["shape"]
            n = int(np.prod(shape)) if shape else 1
            if rec["dtype"] == _BF16:
                nbytes = n * 2
                t = (torch.frombuffer(bytearray(raw[off : off + nbytes]), dtype=torch.bfloat16)
                     if n else torch.empty(0, dtype=torch.bfloat16))
            else:
                dt = np.dtype(rec["dtype"])
                nbytes = n * dt.itemsize
                t = torch.from_numpy(np.frombuffer(raw, dt, count=n, offset=off).copy())
            off += nbytes
            flat[rec["path"]] = t.reshape(shape)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        if flat_sh:
            from ..distributed.elastic import place
        flat = {k: place(v, flat_sh[k]) if k in flat_sh else v.to(dev) for k, v in flat.items()}
        return _unflatten(flat), manifest["extra"]
