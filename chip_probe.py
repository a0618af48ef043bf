#!/usr/bin/env python3
"""Probes of what bounds the port's CUDA kernels on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit, after or beside ``chip_smoke.py``::

    python3 chip_probe.py

The kernel library is built three more times from its own source
(``src/repro_torch/kernels/csrc/range_join.cu``), each with one change made
by text substitution (the script fails if a substitution no longer
applies), and timed in turns with the shipped kernels by ``chip_smoke``'s
``KernelTimer`` on made-up operands of the shapes ``chip_smoke.py`` times:

* ``compute_only``: no stores (the verdicts are computed and dropped);
* ``stores_only``: no compares (the tile is staged and stored);
* ``tiles_32x512``: the mask kernel on 32 q x 512 r block tiles, so a warp
  stores one 512-byte row segment, held against the plain version.

The first two change the block-tile body that both range joins run, so they
also probe ``range_join_tile_masks``: every build is timed on
``chip_smoke.py``'s full-card schedule (64 segments of 2,048 x 2,048 boxes,
4 attributes, 4,096 tiles of 256 x 256), beside ``fill_`` of the same
268,435,456 output bytes, and on a schedule shaped like phase 4's accel-DAG
waves (20 segments of 512 x 512 boxes, 2 attributes, 80 tiles), beside the
launch floor: the time a launch of an empty kernel (``torch.cuda._sleep(0)``)
takes back to back.

Beside them: the write ceiling (``torch`` ``fill_`` of a 20,000 x 20,000
uint8 mask), the SM clock and power sampled by ``nvidia-smi`` while the
shipped kernel runs back to back at 20,000 x 20,000 x 4, and, for
``run_boundaries_packed``, a ``torch`` strided copy of the live lanes of a
4,194,304-row table (the same sectors the kernel reads).  Every line names
the card and its power limit.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
MASK_SHAPES = ((200, 20_000, 2), (3000, 20_000, 2), (20_000, 20_000, 4), (2000, 3000, 64))
SYMBOLS = ("rj_range_join_mask", "rj_range_join_tile_masks", "rb_run_boundaries",
           "rj_error_string")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise AssertionError(f"probe substitution no longer applies: {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """The probe builds of ``range_join.cu``: name -> (source, exact)."""
    wide = _sub(src, "using MaskGeometry = Geometry<256, MAXK>;",
                "using MaskGeometry = Geometry<512, MAXK>;")
    return {
        "compute_only": (_sub(src, "if (rr < nr) {",
                              "if (rr < nr && w[0][0] == 0xdeadbeefu && w[3][3] == 0x12345678u) {"),
                         False),
        "stores_only": (_sub(src, "  if (k0) dense_pass_k(st, k0, tq, tr, w);\n", ""), False),
        "tiles_32x512": (wide, True),
    }


def build_variants(_build, lib, out_dir: Path) -> dict:
    """Compile every probe build (one ``nvcc`` per source, all at once) and
    bind each like ``lib``."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    rb_src = csrc / "run_boundary.cu"
    procs = []
    for name, (src, _) in variants((csrc / "range_join.cu").read_text()).items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "range_join.cu").write_text(src)
        renames = [f"-D{s}={name}_{s}" for s in SYMBOLS]
        for cu in (d / "range_join.cu", rb_src):
            obj = d / f"{cu.stem}.o"
            procs.append((name, obj, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *renames, "-c", "-o", str(obj), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
    objs: dict = {}
    for name, obj, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} probe:\n{err[-4000:]}")
        objs.setdefault(name, []).append(str(obj))
    libs = {}
    for name, files in objs.items():
        so = out_dir / name / "lib.so"
        subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", str(so), *files],
                       check=True, capture_output=True)
        handle = ctypes.CDLL(str(so))
        fns = {}
        for sym in SYMBOLS:
            fn = getattr(handle, f"{name}_{sym}")
            fn.argtypes, fn.restype = getattr(lib, sym).argtypes, getattr(lib, sym).restype
            fns[sym] = fn
        libs[name] = SimpleNamespace(**fns)
    return libs


def probe_tiles(torch, cs, ref, libs, exact, timers, rng, n_seg, rows, na) -> None:
    """Every build's tile kernel on ``n_seg`` made-up segments of ``rows`` x
    ``rows`` boxes, block-diagonal at 256 x 256, timed in turns (exact builds
    held against the plain version), beside ``fill_`` of the output."""
    stream = torch.cuda.current_stream().cuda_stream
    q = cs.packed_boxes(torch, rng, n_seg * rows, na, "cuda")
    r = cs.packed_boxes(torch, rng, n_seg * rows, na, "cuda")
    tq_host, tr_host = cs.diagonal_schedule(torch, n_seg, rows, 256, 256)
    tq, tr = tq_host.cuda(), tr_host.cuda()
    n_tiles = tq.shape[0]
    want = cs.plain_tiles(torch, ref, q, r, tq, tr, na, 256, 256)
    out = torch.empty_like(want)

    def launch(L):
        return lambda: cs.checked(L.rj_range_join_tile_masks(
            q.data_ptr(), r.data_ptr(), tq.data_ptr(), tr.data_ptr(), out.data_ptr(),
            n_tiles, 256, 256, na, stream))

    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            launch(libs[name])()
            torch.cuda.synchronize()
            if exact[name] and not torch.equal(out, want):
                raise AssertionError(f"{name} differs from plain at {n_seg}seg x {rows}x{na}")
            times[name].append(timers[name].ms(launch)[0])
    bound_ms, _ = cs.bound(out.numel() + 2 * n_seg * rows * 8 * na + 8 * n_tiles, 0)
    fill_ms, _ = timers["shipped"].ms(lambda L: lambda: out.fill_(1))
    print(f"range_join_tile_masks {n_seg}seg x {rows}x{rows}x{na}/{n_tiles}tiles@256x256 "
          f"(bound {bound_ms:.4f} ms; fill_ of its {out.numel():,} bytes {fill_ms:.4f} ms): "
          + " ".join(f"{name}={np.mean(t):.4f}ms" for name, t in times.items()))


def sample_clocks(stop: threading.Event, samples: list) -> None:
    while not stop.is_set():
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
        samples.append(out.stdout.strip())
        time.sleep(0.1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    card = cs.gpu_name_and_power()
    lib = _build.load()
    libs = {"shipped": lib, **build_variants(_build, lib, ROOT / "build" / "probe")}
    exact = {"shipped": True, **{k: v[1] for k, v in
                                 variants((ROOT / "src/repro_torch/kernels/csrc/range_join.cu")
                                          .read_text()).items()}}
    timers = {name: cs.KernelTimer(torch, fns) for name, fns in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    print(f"card: {card}")
    for nq, nr, na in MASK_SHAPES:
        q = cs.packed_boxes(torch, rng, nq, na, "cuda")
        r = cs.packed_boxes(torch, rng, nr, na, "cuda")
        want = cs.plain_blocked(torch, ref.range_join_mask_ref, q, r, na)
        out = torch.empty((nq, nr), dtype=torch.uint8, device="cuda")
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                cs.checked(libs[name].rj_range_join_mask(
                    q.data_ptr(), r.data_ptr(), out.data_ptr(), nq, nr, na, stream))
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, want):
                    raise AssertionError(f"{name} differs from plain at {nq}x{nr}x{na}")
                ms, _ = timers[name].ms(lambda L: lambda: cs.checked(L.rj_range_join_mask(
                    q.data_ptr(), r.data_ptr(), out.data_ptr(), nq, nr, na, stream)))
                times[name].append(ms)
        bound_ms, _ = cs.bound(nq * nr + (nq + nr) * 8 * na, 0)
        print(f"range_join_mask {nq}x{nr}x{na} (bound {bound_ms:.4f} ms): " + " ".join(
            f"{name}={np.mean(t):.4f}ms" for name, t in times.items()))
    for n_seg, rows, na in (cs.TILE_SCHEDULES[0], (20, 512, 2)):
        probe_tiles(torch, cs, ref, libs, exact, timers, rng, n_seg, rows, na)
    floor_ms, _ = timers["shipped"].ms(lambda L: lambda: torch.cuda._sleep(0))
    print(f"launch floor: torch.cuda._sleep(0) back to back {floor_ms:.4f} ms")
    big = torch.empty((20_000, 20_000), dtype=torch.uint8, device="cuda")
    fill_ms, _ = timers["shipped"].ms(lambda L: lambda: big.fill_(1))
    print(f"write ceiling: fill_ of 400,000,000 bytes {fill_ms:.4f} ms "
          f"= {4e8 / fill_ms / 1e9:.3f} TB/s")
    q = cs.packed_boxes(torch, rng, 20_000, 4, "cuda")
    r = cs.packed_boxes(torch, rng, 20_000, 4, "cuda")
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(stop, samples))
    sampler.start()
    launches, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(100):
            cs.checked(lib.rj_range_join_mask(q.data_ptr(), r.data_ptr(), big.data_ptr(),
                                              20_000, 20_000, 4, stream))
        launches += 100
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stop.set()
    sampler.join()
    steady = samples[len(samples) // 4:] or samples
    print(f"range_join_mask 20000x20000x4 back to back: {launches} launches in {dt:.3f} s "
          f"(host clock); nvidia-smi clocks.sm, power.draw: {steady[:8]}")
    n = 1 << 22
    p = cs.rb_table(torch, n, 4, seed=3)
    flags = torch.empty(n, dtype=torch.uint8, device="cuda")
    live = torch.empty((n, 8), dtype=torch.int32, device="cuda")
    kernel_ms, _ = timers["shipped"].ms(lambda L: lambda: cs.checked(L.rb_run_boundaries(
        p.data_ptr(), flags.data_ptr(), n, 4, 1024, stream)))
    copy_ms, _ = timers["shipped"].ms(lambda L: lambda: live.copy_(p[:, :8]))
    print(f"run_boundaries_packed {n}x4: kernel {kernel_ms:.4f} ms; torch copy_ of lanes "
          f"[0, 8) (the same sectors) {copy_ms:.4f} ms; bound "
          f"{cs.rb_bytes(n, 4) / cs.PEAK_BYTES_PER_S * 1e3:.4f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
