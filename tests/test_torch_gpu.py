"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA GPU and skips without one: the CUDA kernels
have no CPU mode.  This file imports no JAX (the GPU machine has none), so
it runs there with::

    python -m pytest -m gpu tests/test_torch_gpu.py

The plain PyTorch versions these compare against are themselves held
against the JAX package's Pallas kernels on the CPU in
``test_torch_kernels.py``; integer outputs are compared exactly.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.core import capture as C
from repro_torch.kernels import ops
from repro_torch.kernels import range_join as rj
from repro_torch.kernels import ref

SEED = 20240527
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _packed(rng, n, n_attrs, coord=6, width=5):
    p = np.zeros((n, 128), np.int32)
    lo = rng.integers(0, coord, (n, n_attrs))
    p[:, :n_attrs] = lo
    p[:, n_attrs : 2 * n_attrs] = lo + rng.integers(0, width, (n, n_attrs))
    return p


@pytest.mark.parametrize("nq,nr,n_attrs", [
    (255, 257, 1), (256, 256, 2), (1, 1, 3), (33, 1000, 9), (300, 200, 64), (0, 7, 2),
])
def test_mask_kernel_equals_plain(cuda_device, nq, nr, n_attrs):
    rng = np.random.default_rng(SEED + n_attrs)
    q = torch.from_numpy(_packed(rng, nq, n_attrs)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, nr, n_attrs)).to(cuda_device)
    before = rj.range_join_mask.launches
    got = rj.range_join_mask(q, r, n_attrs=n_attrs)
    torch.cuda.synchronize()
    # a zero-sized mask is never launched (an empty grid is invalid)
    assert rj.range_join_mask.launches == before + (1 if nq and nr else 0)
    assert torch.equal(got, ref.range_join_mask_ref(q, r, n_attrs))


@pytest.mark.parametrize("bq,br", [(64, 64), (128, 128), (256, 256), (64, 256)])
def test_tile_kernel_equals_plain(cuda_device, bq, br):
    rng = np.random.default_rng(SEED + bq)
    q = torch.from_numpy(_packed(rng, 3 * bq, 2, coord=40)).to(cuda_device)
    r = torch.from_numpy(_packed(rng, 5 * br, 2, coord=40)).to(cuda_device)
    # the wrapper takes the schedule on the host; the plain version indexes
    # on the card
    tq = torch.from_numpy(rng.integers(0, 3, 11).astype(np.int32))
    tr = torch.from_numpy(rng.integers(0, 5, 11).astype(np.int32))
    before = rj.range_join_tile_masks.launches
    got = rj.range_join_tile_masks(q, r, tq, tr, n_attrs=2, block_q=bq, block_r=br)
    torch.cuda.synchronize()
    assert rj.range_join_tile_masks.launches == before + 1
    want = ref.range_join_tile_masks_ref(
        q, r, tq.to(cuda_device), tr.to(cuda_device), 2, bq, br
    )
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="host"):
        rj.range_join_tile_masks(q, r, tq.to(cuda_device), tr.to(cuda_device),
                                 n_attrs=2, block_q=bq, block_r=br)


@pytest.mark.parametrize("layout", ["dense", "blockdiag"])
def test_segmented_pairs_on_card_equal_cpu(cuda_device, layout):
    rng = np.random.default_rng(SEED)
    segs = []
    for l in (1, 2, 3, 2):
        nq, nr = int(rng.integers(50, 300)), int(rng.integers(50, 300))
        q_lo, r_lo = rng.integers(0, 60, (nq, l)), rng.integers(0, 60, (nr, l))
        segs.append((q_lo, q_lo + rng.integers(0, 6, (nq, l)),
                     r_lo, r_lo + rng.integers(0, 6, (nr, l))))
    want, winfo = ops.segmented_range_join_pairs(segs, 64, 128, device="cpu", layout=layout)
    got, ginfo = ops.segmented_range_join_pairs(segs, 64, 128, device=cuda_device,
                                                layout=layout)
    assert ginfo == winfo
    for (gq, gr), (wq, wr) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("rels", [
    [C.slice_lineage((64, 64), (0, 0), (64, 64), (2, 2)), C.identity_lineage((32, 32)),
     C.transpose_lineage((32, 32), (1, 0)), C.reduce_lineage((32, 32), 1)],
    [C.conv2d_lineage(32, 32, 3, 3), C.identity_lineage((30, 30)),
     C.conv2d_lineage(30, 30, 3, 3)],
])
def test_dslog_on_card_equals_cpu(cuda_device, rels):
    stores = [core.DSLog(device="cpu"), core.DSLog(device=cuda_device)]
    for store in stores:
        store.define_array("a0", rels[0].in_shape)
        for k, rel in enumerate(rels):
            store.define_array(f"a{k + 1}", rel.out_shape)
            store.register_operation(f"op{k}", [f"a{k}"], [f"a{k + 1}"],
                                     capture=lambda r=rel: {(0, 0): r}, reuse=False)
    names = [f"a{k}" for k in range(len(rels) + 1)]
    cells = np.stack(np.unravel_index(np.arange(300), rels[0].in_shape), axis=1)
    before = rj.range_join_mask.launches + rj.range_join_tile_masks.launches
    for merge in (True, False):
        for args in ((names, cells), (names[0], names[-1], cells)):
            want = stores[0].prov_query(*args, merge=merge)
            got = stores[1].prov_query(*args, merge=merge)
            assert got.lo.tobytes() == want.lo.tobytes()
            assert got.hi.tobytes() == want.hi.tobytes()
    assert rj.range_join_mask.launches + rj.range_join_tile_masks.launches > before
