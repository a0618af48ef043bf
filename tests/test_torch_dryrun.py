"""The port's dry run (``repro_torch.launch.dryrun``) and abstract states
(``launch.steps.abstract_model``/``abstract_caches``/``abstract_opt_state``)
against the JAX package's, on the CPU.

* The abstract model, caches and AdamW state of all ten architectures at
  their published widths have the reference's ``jax.eval_shape`` shapes,
  dtypes and logical specs.
* ``state_bytes_per_device`` equals the reference's ``_sharded_bytes`` in
  every cell of both production meshes (the reference's side in a
  subprocess that imports ``repro.launch.dryrun``, which forces 512 host
  devices: ``_dist_dryref.py``; the port's with ``--state-only``).
* Dry runs at ``reduced()`` on fake groups of 4, a (2, 2) and a (2, 1, 2)
  mesh, return ``ok`` for every architecture and ``smoke_shape`` kind
  (``skip`` where the reference's rule says), with the reference's keys.
* Flops of a dense qwen2 ``reduced()`` train step equal an analytic count:
  rank 0's products ×3 (forward, and the backward's two), plus the
  forward of every layer again, but for its last product, under
  ``remat="full"``.
* ``account_cell``'s 1-layer/2-layer extrapolation equals the full count
  of a 4-layer model (flops, bytes, transcendentals and collectives), and
  a train step of 4 microbatches run as 2 (the rest counted) the run of
  all 4, peak memory included.
* The fake group's collectives equal ``collectives.traffic`` of the same
  steps on 4 real ``gloo`` ranks, exactly (``_dist_port.py dryreal``), and
  of a step whose 8 model ranks cut its query heads on 8 (``dryrealcut``).
* ``--attn-heads`` changes the program: on (1, 8), which cuts the 4 query
  heads of qwen2's ``reduced()``, ``auto`` splits each attention layer by
  sequence and ``batch_only`` computes it whole; both flop counts equal an
  analytic count, ``auto``'s below ``batch_only``'s by the attention's
  share times ``1 - 1/8``.

Every dry run is a subprocess: it starts its own fake process group.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_cases as K
from _dist_port import finish, start
import repro.configs as jconfigs
from repro.launch import steps as jsteps
import repro_torch.configs as tconfigs
from repro_torch.configs import SHAPES
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import split_name

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
KINDS = ("smoke_train", "smoke_prefill", "smoke_decode")
MESHES = ("2x2", "2x1x2")
PROD = ("pod16x16", "pod2x16x16")
# account_cell against the full count: a 4-layer model of each family
ACCOUNT_ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-780m")
# a train step of 4 microbatches run in 2, the rest counted, against all 4
MICRO_ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b")
# the flops of qwen2-0.5b's reduced() train step on (2, 2), rank 0: one
# sequence of 32 tokens; 2 of 4 query heads, 1 of 2 KV heads (of 16), 64 of
# d_ff 128, 128 of the 256 vocab ids (tied) and d_model 64
QWEN = dict(S=32, D=64, hd=16, h=2, kv=1, f=64, v=128, L=2)


def _env():
    env = dict(os.environ, PYTHONPATH=f"{SRC}:{HERE}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _dryrun(out, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                             "--device", "cpu", "--out", out, *args], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    try:
        out = proc.communicate(timeout=600)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, f"{what}:\n{out[-4000:]}"
    return out


def _record(out, tag, arch, shape) -> dict:
    with open(os.path.join(out, tag, f"{arch}__{shape}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess at once: the reduced sweeps, the 4-layer accounting,
    the float32 cells the real ranks repeat, the production state bytes
    (port and reference) and the 4 real ranks."""
    io = str(tmp_path_factory.mktemp("dryrun"))
    out = os.path.join(io, "records")
    procs = {
        "2x2": _dryrun(out, "--mesh", "2x2", "--reduced", "--skip-account", "--shape",
                       ",".join(KINDS)),
        "2x1x2": _dryrun(out, "--mesh", "2x1x2", "--reduced", "--skip-account", "--shape",
                         ",".join(KINDS)),
        "account": _dryrun(out, "--mesh", "2x2", "--reduced", "--layers", "4", "--tag", "l4",
                           "--arch", ",".join(ACCOUNT_ARCHS), "--shape", ",".join(KINDS)),
        "train32": _dryrun(out, "--mesh", "2x2", "--reduced", "--param-dtype", "float32",
                           "--remat", "full", "--skip-account", "--tag", "f32", "--arch",
                           "qwen2-0.5b", "--shape", "smoke_train"),
        "decode32": _dryrun(out, "--mesh", "1x4", "--reduced", "--param-dtype", "float32",
                            "--global-batch", "1", "--skip-account", "--tag", "f32", "--arch",
                            "qwen2-0.5b", "--shape", "smoke_decode"),
        "micro": _dryrun(out, "--mesh", "2x2", "--reduced", "--n-micro", "4", "--global-batch",
                         "8", "--skip-account", "--tag", "micro", "--arch", ",".join(MICRO_ARCHS),
                         "--shape", "smoke_train"),
        "all_micro": _dryrun(out, "--mesh", "2x2", "--reduced", "--n-micro", "4",
                             "--global-batch", "8", "--skip-account", "--all-micro", "--tag",
                             "all_micro", "--arch", ",".join(MICRO_ARCHS), "--shape",
                             "smoke_train"),
        "cut": _dryrun(out, "--mesh", "1x8", "--reduced", "--param-dtype", "float32",
                       "--skip-account", "--tag", "cut", "--arch", "qwen2-0.5b", "--shape",
                       "smoke_train"),
        "cut_bo": _dryrun(out, "--mesh", "1x8", "--reduced", "--param-dtype", "float32",
                          "--skip-account", "--attn-heads", "batch_only", "--tag", "cut_bo",
                          "--arch", "qwen2-0.5b", "--shape", "smoke_train"),
        "state16": _dryrun(out, "--state-only"),
        "state512": _dryrun(out, "--state-only", "--multi-pod"),
    }
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "_dist_dryref.py"),
                            os.path.join(io, "ref_state.json")], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    real = start("dryreal", K.WORLD, io)
    real_cut = start("dryrealcut", 8, io)
    try:
        real_traffic = finish(real)
        real_cut = finish(real_cut)
        logs = {k: _wait(p, k) for k, p in procs.items()}
        _wait(ref, "reference state bytes")
    finally:
        for p in [*procs.values(), ref]:
            p.kill()
    with open(os.path.join(io, "ref_state.json")) as f:
        ref_state = json.load(f)
    return {"out": out, "logs": logs, "ref_state": ref_state, "real": real_traffic,
            "real_cut": real_cut}


# --------------------------------------------------------------------------- #
# abstract states (in this process: no group, nothing allocated)
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _stacked(model, tensors=None) -> dict:
    """``{path: (shape, dtype name)}`` of ``tensors`` (one a parameter of
    ``model``; its parameters by default) with layer leaves stacked on
    ``L``, as the reference's trees."""
    names = [n for n, _ in model.named_parameters()]
    tensors = list(model.parameters()) if tensors is None else tensors
    out = {}
    for name, t in zip(names, tensors):
        path, idx = split_name(name)
        leaf = ((len(model.layers),) if idx else ()) + tuple(t.shape), str(t.dtype)[6:]
        assert out.setdefault("/".join(path), leaf) == leaf, name
    return out


def _want(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch", K.ARCHS)
def test_abstract_model_equals_reference(arch):
    """Shapes, dtypes (bfloat16; the SSM's ``A_log``, ``D`` and ``dt_bias``
    float32) and logical specs of every leaf, at published widths, on the
    ``meta`` device."""
    jshapes, jspecs = jsteps.abstract_model(jconfigs.get_arch(arch), jnp.bfloat16)
    model, specs = tsteps.abstract_model(tconfigs.get_arch(arch), torch.bfloat16)
    assert all(p.is_meta for p in model.parameters())
    assert _stacked(model) == _want(jshapes)
    assert _flat(specs) == {k: tuple(v) for k, v in _flat(jspecs).items()}


@pytest.mark.parametrize("arch", K.ARCHS)
def test_abstract_caches_and_opt_state_equal_reference(arch):
    """``abstract_caches`` at the decode shapes' batch and length (bfloat16
    and the fp8 option) and ``abstract_opt_state``'s moments and step."""
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for shape in ("decode_32k", "long_500k"):
        s = SHAPES[shape]
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
            want = jsteps.abstract_caches(jcfg, s.global_batch, s.seq_len, jdt)
            got = tsteps.abstract_caches(tcfg, s.global_batch, s.seq_len, tdt)
            assert all(t.is_meta for t in got.values())
            assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == \
                _want(want)
    jopt = jsteps.abstract_opt_state(jsteps.abstract_model(jcfg, jnp.bfloat16)[0])
    model, _ = tsteps.abstract_model(tcfg, torch.bfloat16)
    opt = tsteps.abstract_opt_state(model)
    for part in ("m", "v"):
        assert _stacked(model, opt[part]) == _want(jopt[part]), part
    assert (tuple(opt["step"].shape), str(opt["step"].dtype)[6:]) == \
        (tuple(jopt["step"].shape), str(jopt["step"].dtype)) == ((), "int32")


# --------------------------------------------------------------------------- #
# the dry runs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", K.ARCHS)
@pytest.mark.parametrize("tag", PROD)
def test_state_bytes_equal_reference(runs, tag, arch):
    """Rank 0's held bytes of parameters and AdamW state, parameters, or
    parameters and caches equal the reference's ``_sharded_bytes`` in each
    shape; the skipped cells are the reference's."""
    for shape in SHAPES:
        rec = _record(runs["out"], tag, arch, shape)
        key = f"{tag}|{arch}|{shape}"
        if key not in runs["ref_state"]:
            assert rec["status"] == "skip", key
            continue
        assert rec["status"] == "ok", key
        assert rec["state_bytes_per_device"] == runs["ref_state"][key], key


KEYS = {"arch", "shape", "mesh", "kind", "plan", "overrides", "lower_s", "compile_s",
        "memory_analysis", "cost_analysis", "collectives_scan_program", "hlo_bytes",
        "state_bytes_per_device", "collectives", "status", "fits", "card"}


@pytest.mark.parametrize("arch", K.ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_reduced_dry_runs_are_ok(runs, mesh, arch):
    """Every ``smoke_shape`` kind of ``arch`` at ``reduced()`` on a fake
    group of 4: ``ok`` with the reference's keys and sane numbers, or
    ``skip`` (an encoder has no decode)."""
    for kind in KINDS:
        rec = _record(runs["out"], f"mesh{mesh}", arch, kind)
        if tconfigs.get_arch(arch).encoder_only and kind == "smoke_decode":
            assert rec["status"] == "skip", rec
            assert rec["reason"] == "encoder-only arch has no autoregressive decode"
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert KEYS <= set(rec), KEYS - set(rec)
        mem = rec["memory_analysis"]
        assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        assert mem["argument_size_in_bytes"] > rec["state_bytes_per_device"] > 0
        assert rec["cost_analysis"]["flops"] > 0 and rec["fits"] is None
        assert rec["mesh"] == mesh and rec["card"] == "cpu"
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(v["bytes"] for k, v in coll.items()
                                          if k != "total_bytes")


def _analytic_flops(remat: bool) -> float:
    """Rank 0's products ×3; under remat, a layer's forward again but for
    its last product (``down``): the non-reentrant checkpoint stops
    recomputing once the tensors the backward saved are back."""
    q = QWEN
    layer = 2 * q["S"] * q["D"] * (2 * q["h"] * q["hd"] + 2 * q["kv"] * q["hd"])  # q, o; k, v
    layer += 2 * 2 * q["h"] * q["S"] * q["S"] * q["hd"]  # scores and their weights on v
    down = 2 * q["S"] * q["f"] * q["D"]
    layer += 2 * 2 * q["S"] * q["D"] * q["f"] + down  # up, gate, down
    head = 2 * q["S"] * q["D"] * q["v"]
    return 3 * (q["L"] * layer + head) + (q["L"] * (layer - down) if remat else 0)


def test_flops_equal_an_analytic_count(runs):
    """qwen2-0.5b's reduced() train step on (2, 2), rank 0: ×3 without remat
    (the sweep's, bfloat16) and plus the recompute under ``remat="full"``
    (float32)."""
    plain = _record(runs["out"], "mesh2x2", "qwen2-0.5b", "smoke_train")
    remat = _record(runs["out"], "mesh2x2_f32", "qwen2-0.5b", "smoke_train")
    assert plain["cost_analysis"]["flops"] == _analytic_flops(False) == 9437184
    assert remat["cost_analysis"]["flops"] == _analytic_flops(True)


def _cut_flops(split: str) -> float:
    """Rank 0's products ×3 for qwen2-0.5b's reduced() train step on
    (1, 8): both sequences of 32 tokens (``T`` = 64), 4 of 256 d_ff, 32 of
    the 256 vocab ids, d_model 64; the attention (4 query and 2 KV heads of
    16) whole, or under ``"seq"`` ``q``, ``o`` and the scores for the
    rank's 4 rows of each sequence (``k``/``v`` whole)."""
    q = dict(B=2, S=32, D=64, hd=16, h=4, kv=2, f=16, v=32, L=2, m=8)
    t = q["B"] * q["S"]
    rows = 1 / q["m"] if split == "seq" else 1
    layer = 2 * t * q["D"] * 2 * q["kv"] * q["hd"]  # k, v
    layer += rows * 2 * t * q["D"] * 2 * q["h"] * q["hd"]  # q, o
    layer += rows * 2 * 2 * q["B"] * q["h"] * q["S"] * q["S"] * q["hd"]  # scores, weights on v
    layer += 3 * 2 * t * q["D"] * q["f"]  # up, gate, down
    return 3 * (q["L"] * layer + 2 * t * q["D"] * q["v"])


def test_attn_heads_changes_the_program(runs):
    """``--attn-heads``: on (1, 8) ``auto`` splits both attention layers by
    sequence, ``batch_only`` computes them whole; each flop count equals
    the analytic one, and ``auto``'s falls below ``batch_only``'s by the
    attention's share (``q``, ``o``, the scores and their weights on
    ``v``) times ``1 - 1/8``, so does its peak."""
    auto = _record(runs["out"], "mesh1x8_cut", "qwen2-0.5b", "smoke_train")
    whole = _record(runs["out"], "mesh1x8_cut_bo", "qwen2-0.5b", "smoke_train")
    assert auto["attn_split"] == ["seq", "seq"] and whole["attn_split"] == ["whole", "whole"]
    assert auto["overrides"].get("attn_heads") is None
    assert whole["overrides"]["attn_heads"] == "batch_only"
    assert auto["cost_analysis"]["flops"] == _cut_flops("seq")
    assert whole["cost_analysis"]["flops"] == _cut_flops("whole")
    share = _cut_flops("whole") - _cut_flops("seq")
    assert share == pytest.approx(3 * 2 * (2 * 64 * 64 * 2 * 64 + 4 * 2 * 4 * 32 * 32 * 16)
                                  * (1 - 1 / 8))
    assert auto["memory_analysis"]["peak_bytes"] < whole["memory_analysis"]["peak_bytes"]
    assert auto["state_bytes_per_device"] == whole["state_bytes_per_device"]


@pytest.mark.parametrize("arch", ACCOUNT_ARCHS)
def test_account_cell_extrapolation_equals_the_full_count(runs, arch):
    """At 4 layers, ``c1 + 3 (c2 - c1)`` from the 1- and 2-layer runs equals
    the full run's count of every cost and collective, for each kind."""
    for kind in KINDS:
        rec = _record(runs["out"], "mesh2x2_l4", arch, kind)
        assert rec["status"] == "ok" and rec["n_layers"] == 4, rec.get("error")
        assert rec["cost_accounted"] == rec["cost_analysis"], kind
        assert rec["collectives"] == rec["collectives_scan_program"], kind


@pytest.mark.parametrize("arch", MICRO_ARCHS)
def test_two_microbatches_count_as_all(runs, arch):
    """A train step of 4 microbatches on (2, 2), run as 2 with the last
    counted twice more, has the counts, traffic and memory of the run of
    all 4."""
    got = _record(runs["out"], "mesh2x2_micro", arch, "smoke_train")
    want = _record(runs["out"], "mesh2x2_all_micro", arch, "smoke_train")
    assert (got["n_micro_run"], want["n_micro_run"], got["plan"]["n_micro"]) == (2, 4, 4)
    for key in ("cost_analysis", "memory_analysis", "traffic", "collectives",
                "state_bytes_per_device"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("kind", ["train", "decode", "cut_heads"])
def test_fake_traffic_equals_real_ranks(runs, kind):
    """The fake group's rank 0 issues the collectives that real ``gloo``
    ranks issue in the same step, call for call and byte for byte: a
    (2, 2) train step, a batch-1 decode step whose sequence lies over
    ``("data", "model")`` on (1, 4), and a (1, 8) train step whose
    attention splits by sequence (its weights gathered over the model
    ranks, their gradients reduce-scattered there)."""
    if kind == "cut_heads":
        rec = _record(runs["out"], "mesh1x8_cut", "qwen2-0.5b", "smoke_train")
        for r in runs["real_cut"]:
            assert r["train"] == rec["traffic"]
            assert r["splits"] == rec["attn_split"] == ["seq", "seq"]
        # q, k, v with biases and o gathered in each layer, their gradients summed
        assert rec["traffic"]["model_reduce_scatter"][0] == 7 * 2
        return
    mesh = "2x2" if kind == "train" else "1x4"
    rec = _record(runs["out"], f"mesh{mesh}_f32", "qwen2-0.5b", f"smoke_{kind}")
    for r in runs["real"]:
        assert r[kind] == rec["traffic"]
    if kind == "decode":
        assert rec["traffic"]["seq_all_reduce"][0] == 3 * 2  # m, l, o in each layer


def test_a_process_with_a_group_is_refused(tmp_path):
    """``fake_group`` never starts inside a process that has a group."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_group

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="has none"):
            with fake_group(4):
                pass
    finally:
        dist.destroy_process_group()


def test_the_sweep_covers_every_cell(runs):
    """The production state sweeps wrote a record for every cell; the
    printed summaries count no error."""
    for tag in PROD:
        assert len(os.listdir(os.path.join(runs["out"], tag))) == len(K.ARCHS) * len(SHAPES)
    for name, log in runs["logs"].items():
        assert " 0 error" in log.splitlines()[-1], name
    assert np.isfinite(_analytic_flops(True))


def test_the_dry_run_imports_neither_jax_nor_repro():
    """Importing ``repro_torch.launch.dryrun`` loads no JAX and nothing of
    the JAX package, and starts no process group."""
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad or dist.is_initialized() else 0)\n"
    )
    env = _env()
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
