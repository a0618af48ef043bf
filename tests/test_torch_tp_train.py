"""Tensor parallelism and ZeRO-3 placement of the training parameters:
the port's ``train_loop(model_parallel=2)`` on a (2, 2) ``("data",
"model")`` mesh of 4 ``gloo`` processes on the CPU, for every
architecture at ``reduced()``, against the JAX package's jitted
``make_train_step`` on one device over the global batch (``_tp_ref.py``).

Each rank holds the block of every parameter and of both AdamW moments
that the reference's ``NamedSharding`` gives its mesh coordinate
(``devices_indices_map``, from a reference subprocess on 4 forced host
devices), and only those bytes.  Dense architectures equal the reference's
``n_micro = 1`` step; an MoE's router sees its data rank's block, so MoE
architectures equal ``n_micro = dp`` (``ROADMAP.md`` §3, closing
paragraph).  The reference's own step on a (2, 2) mesh (GSPMD) agrees as
well.  rtol = atol = 2e-4: the split products and the reductions over the
ranks sum in another order than one device.
"""

import os

import numpy as np
import pytest

import _dist_cases as K
from _dist_port import finish, start
from _tp_ref import (block_bytes, check_blocks, check_metrics, check_run, close, finish_reference,
                     initial_tree, is_moe, reference_steps, saved, start_reference, whole)
import repro_torch.configs as tconfigs

DP = 2  # the (2, 2) mesh's data ranks
SSM_GATHERED = ["layers/ssm/conv_b", "layers/ssm/conv_w", "layers/ssm/in_proj/w",
                "layers/ssm/out_proj/w"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks (``tp4``) and the reference's subprocess (its blocks
    and its own (2, 2) step) run while this process computes the
    reference's single-device steps."""
    io = str(tmp_path_factory.mktemp("tp"))
    np.savez(os.path.join(io, "tp_init.npz"),
             **{f"{name}|{p}": a for name, _ in K.TP_MESH_STEP
                for p, a in K.flat(initial_tree(name)).items()})
    ref_proc = start_reference(io, "tp")
    try:
        started = start("tp4", K.WORLD, io)
        try:
            ref = {name: reference_steps(name, DP if is_moe(name) else 1) for name in K.ARCHS}
        finally:
            ranks = finish(started)
    finally:
        reference = finish_reference(ref_proc, io)
    return {"io": io, "ref": ref, "ranks": ranks, "reference": reference}


@pytest.mark.parametrize("name", K.ARCHS)
def test_mesh_train_equals_reference_single_device(runs, name):
    """Metrics and the gathered parameters after each of 3 steps; every
    rank reports the same losses and gathers the same tree."""
    got = runs["ranks"][0][name]
    check_run(runs["io"], f"tp22_{name}", got, runs["ref"][name], is_moe(name))
    for r in runs["ranks"]:
        assert r[name]["digest"] == got["digest"] and r[name]["losses"] == got["losses"]
    if is_moe(name):
        assert got["metrics"][0]["aux"] > 0.5  # so the two loss rules differ here


@pytest.mark.parametrize("name", K.ARCHS)
def test_each_rank_holds_the_reference_blocks(runs, name):
    """Each rank's block of every parameter (after ``train_loop``) and of
    both moments (after a placed step) is the reference's
    ``NamedSharding`` block at its mesh coordinate, and it holds those
    bytes alone: between a quarter and all of the model, by the
    demotions."""
    ref = runs["reference"]["blocks"][f"2x2|{name}"]
    total = sum(block_bytes(whole(by)) for by in ref.values())
    for r in runs["ranks"]:
        check_blocks(r[name], r["coord"], ref)
        assert total / 4 <= r[name]["held"]["params"] < total


def test_replicated_over_model_on_a_2x2_mesh(runs):
    """The (2, 2) mesh splits every head on a head boundary (4 heads, 2 KV
    heads over 2 model ranks): only the SSM block, whose fused segments any
    contiguous split cuts, computes whole; qwen2 names nothing."""
    for r in runs["ranks"]:
        for name in K.ARCHS:
            family = tconfigs.get_arch(name).family
            want = SSM_GATHERED if family in ("ssm", "hybrid") else []
            assert r[name]["replicated"] == want, name
    assert runs["ranks"][0]["qwen2-0.5b"]["replicated"] == []


@pytest.mark.parametrize("name,n_micro", K.TP_MESH_STEP)
def test_reference_mesh_step_agrees(runs, name, n_micro):
    """The reference's own jitted step on a (2, 2) mesh of 4 host devices
    (GSPMD's collectives) from the same weights and batches: the port's
    (2, 2) run within 2e-4, step by step."""
    got = runs["ranks"][0][name]["metrics"]
    for s, want in enumerate(runs["reference"]["mesh_step"][name]):
        check_metrics(got[s], want, n_micro > 1, f"step {s}")
        port = saved(runs["io"], f"tp22_{name}", s)
        ref = saved(runs["io"], f"refmesh_{name}", s)
        assert set(port) == set(ref)
        for path, w in ref.items():
            close(port[path], w, f"step {s} {path}")


def test_remat_on_a_mesh_keeps_the_gradient(runs):
    """Remat ``full`` and ``dots`` recompute a layer's ZeRO-3 gathers and
    model-axis collectives in the backward, in the same order on every
    rank: each placed gradient equals ``nothing``'s (atol 1e-6)."""
    for r in runs["ranks"]:
        for arch, errs in r["remat"].items():
            for remat, err in errs.items():
                assert err <= 1e-6, (arch, remat, err)


def test_microbatched_step_on_a_mesh_equals_one_microbatch(runs):
    """``n_micro = 2`` on a (2, 2) mesh: each microbatch's ZeRO-3
    reduce-scatters and the data-group mean accumulate to the gradient of
    one microbatch of both rows (a dense model), so one step lands on the
    same parameters and ``grad_norm``."""
    for r in runs["ranks"]:
        assert r["micro"]["params"] <= 2e-4 and r["micro"]["grad_norm"] <= 2e-4, r["micro"]
