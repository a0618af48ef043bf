"""The port's distributed pieces (``repro_torch.launch.mesh``,
``distributed.sharding``, ``collectives``, ``elastic.reshard_tree``,
``CheckpointManager.restore(shardings=)``) against the JAX package's, on
the CPU at equal mesh shapes.

One module fixture runs both sides once: the reference in a subprocess
with 4 host devices (``_dist_ref.py``), the port in 4 ``gloo`` processes
(``_dist_port.py``), both on the same inputs (``_dist_cases.py``).  Specs
are compared entry for entry; each placement's block on each rank is
compared with the reference's block on the device at the same mesh
coordinates, and the rank checks its values and the gathered tensor
against the host array bit for bit.  Where the reference has no block map
(a dimension its axes do not divide: ``attn_heads="tp_uneven"``), the
port's block is JAX's padded block, ``ceil(n / k)`` rows a device.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_cases as K
import repro.configs as jconfigs
from _dist_port import spawn
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models.blocks import init_caches as j_init_caches
from repro.models.model import init_model as j_init_model
import repro_torch.configs as tconfigs
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as tmesh
from repro_torch.models.convert import shape_tree, spec_tree
from repro_torch.models.layers import Init
from repro_torch.models.model import LM

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")


def _run_reference(io):
    env = {"PYTHONPATH": f"{os.path.join(ROOT, 'src')}:{HERE}", "PATH": "/usr/bin:/bin",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={K.WORLD}"}
    for var in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):  # see test_distributed.py
        if var in os.environ:
            env[var] = os.environ[var]
    return subprocess.Popen([sys.executable, os.path.join(HERE, "_dist_ref.py"), io], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results: (reference, [port rank 0..3], inputs)."""
    io = str(tmp_path_factory.mktemp("dist"))
    cfg = jconfigs.get_arch("qwen2-0.5b").reduced()
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(7), cfg)[0])
    rng = np.random.default_rng(20240527)
    f = K.FLASH
    inputs = {**{f"tree/{p}": a for p, a in K.flat(tree).items()},
              "q": rng.standard_normal((f["b"], f["h"], 1, f["d"])).astype(np.float32),
              "k": rng.standard_normal((f["b"], f["h"], f["t"], f["d"])).astype(np.float32),
              "v": rng.standard_normal((f["b"], f["h"], f["t"], f["d"])).astype(np.float32),
              "ring": rng.standard_normal((K.WORLD, 3, 5)).astype(np.float32)}
    np.savez(os.path.join(io, "inputs.npz"), **inputs)
    JManager(os.path.join(io, "ref_ckpt")).save(3, tree, extra={"step": 3})
    shapes = {}
    for arch, b, t, red in K.CACHES:
        if not red:
            c = jax.eval_shape(lambda: j_init_caches(jconfigs.get_arch(arch), b, t, jnp.float32))
            shapes[f"{arch}|{b}"] = {k: list(v.shape) for k, v in c.items()}
    with open(os.path.join(io, "cache_shapes.json"), "w") as fh:
        json.dump(shapes, fh)
    ref = _run_reference(io)
    try:
        port = spawn("sharding", K.WORLD, io)
        out = ref.communicate(timeout=300)[0]
    finally:
        ref.kill()
    assert ref.returncode == 0, out[-4000:]
    with open(os.path.join(io, "reference.json")) as fh:
        reference = json.load(fh)
    reference.update(np.load(os.path.join(io, "reference.npz")))
    return reference, port, inputs


def _same_on_every_rank(port, key):
    for r in port[1:]:
        assert r[key] == port[0][key]
    return port[0][key]


# --------------------------------------------------------------------------- #
# logical specs (in process)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", K.ARCHS)
def test_spec_tree_equals_reference(name):
    """The port's logical spec tree at ``reduced()`` is the reference's
    ``init_model(...)[1]``, and its reference-layout shapes are the
    reference's, at ``reduced()`` and at the published widths."""
    jcfg, tcfg = jconfigs.get_arch(name).reduced(), tconfigs.get_arch(name).reduced()
    values, specs = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = LM(Init(None, "meta"), tcfg)
    assert spec_tree(model) == specs
    assert jax.tree.map(lambda a: tuple(a.shape), values) == _shapes(shape_tree(model))
    full = jax.eval_shape(lambda k: j_init_model(k, jconfigs.get_arch(name))[0],
                          jax.random.PRNGKey(0))
    full_model = LM(Init(None, "meta"), tconfigs.get_arch(name))
    assert jax.tree.map(lambda a: tuple(a.shape), full) == _shapes(shape_tree(full_model))
    assert spec_tree(full_model) == specs


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}


def test_named_sharding_placements():
    """A dimension over several mesh axes is one ``Shard`` on each, in mesh
    order; a one-axis tuple is kept as its name, as ``PartitionSpec``
    keeps it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    sh = S.NamedSharding(mesh, (("pod", "data"), None, "model", ("data",)))
    assert sh.spec == (("pod", "data"), None, "model", "data")
    with pytest.raises(ValueError, match="splits two dimensions"):
        _ = sh.placements
    sh = S.NamedSharding(mesh, (None, ("pod", "data", "model")))
    assert sh.placements == (Shard(1), Shard(1), Shard(1))
    sh = S.NamedSharding(mesh, (("pod", "data"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(NotImplementedError, match="mesh's order"):
        _ = S.NamedSharding(mesh, (("data", "pod"),)).placements
    assert S.NamedSharding(mesh, ((), None)).placements == (Replicate(),) * 3


def test_hint_is_the_identity_without_a_mesh():
    x = torch.ones(2, 4, 8)
    assert S.hint(x, "hidden") is x
    with pytest.raises(RuntimeError, match="set_activation_mesh"):
        S.hint_spec(x.shape, "hidden")


def test_meshes_need_a_process_group():
    """No mesh starts a group of its own (``DeviceMesh`` would): without an
    initialised group each mesh function raises, and none is left behind."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    for call in (lambda: tmesh.local_mesh(1, device="cpu"),
                 lambda: tmesh.make_mesh((1, 1), ("data", "model"), device="cpu"),
                 lambda: tmesh.make_production_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call()
    assert not dist.is_initialized()
    assert tmesh.rank_device("cpu") == torch.device("cpu")


# --------------------------------------------------------------------------- #
# shardings on 4 ranks against the reference on 4 host devices
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", list(K.MESHES))
def test_param_sharding_equals_reference(runs, mesh):
    """Every architecture's spec tree at ``reduced()`` and at the published
    widths (shapes from the meta device), entry for entry.  A width its
    axes do not divide is demoted to replication: on 1 x 4, hymba-1.5b's
    SSM ``in_proj`` keeps no ``model`` axis."""
    reference, port, _ = runs
    got = _same_on_every_rank(port, "param")
    keys = [k for k in reference["param"] if k.startswith(f"{mesh}|")]
    assert len(keys) == 2 * len(K.ARCHS)
    for key in keys:
        assert got[key] == reference["param"][key], key
    if mesh == "1x4":
        assert got["1x4|hymba-1.5b|False"]["layers/ssm/in_proj/w"] == [None, "data", None]
        assert got["1x4|hymba-1.5b|True"]["layers/ssm/in_proj/w"] == [None, "data", "model"]


@pytest.mark.parametrize("mesh", list(K.MESHES))
def test_batch_and_cache_sharding_equal_reference(runs, mesh):
    reference, port, _ = runs
    got = _same_on_every_rank(port, "batch")
    for case, *_ in K.BATCHES:
        assert got[f"{mesh}|{case}"] == reference["batch"][f"{mesh}|{case}"], case
    got = _same_on_every_rank(port, "cache")
    for arch, b, _, red in K.CACHES:
        key = f"{mesh}|{arch}|{b}|{red}"
        assert got[key] == reference["cache"][key], key


def _ceil_blocks(shape, spec, sizes, coord, names):
    """JAX's padded blocks: ``ceil(n / k)`` a device, the last ones short."""
    out = []
    for n, entry in zip(shape, spec):
        axes = [] if entry is None else [entry] if isinstance(entry, str) else entry
        k, i = 1, 0
        for a in axes:
            i = i * sizes[a] + coord[names.index(a)]
            k *= sizes[a]
        c = -(-n // k)
        out.append([min(i * c, n), min((i + 1) * c, n)])
    return out


@pytest.mark.parametrize("mesh", K.HINT_MESHES)
def test_hint_equals_reference(runs, mesh):
    """Every kind, shape and ``attn_heads`` policy: the spec entry for
    entry, and each rank's block of the redistributed ``DTensor`` the
    reference's on its mesh coordinates."""
    reference, port, _ = runs
    shape_m, names = K.MESHES[mesh]
    sizes = dict(zip(names, shape_m))
    uneven = 0
    for policy in K.POLICIES:
        for kind, shape in K.HINTS:
            key = K.hint_key(mesh, policy, kind, shape)
            ref = reference["hint"][key]
            for r in port:
                got = r["hint"][key]
                assert got["spec"] == ref["spec"], key
                coord = r["coord"][mesh]
                if ref["blocks"] is not None:
                    assert got["block"] == ref["blocks"][coord], key
                else:
                    uneven += 1
                    want = _ceil_blocks(shape, ref["spec"], sizes,
                                        [int(c) for c in coord.split(",")], names)
                    assert got["block"] == want, key
    if mesh == "2x2":
        assert uneven > 0  # tp_uneven heads were redistributed unevenly


@pytest.mark.parametrize("mesh", K.PLACE_MESHES)
def test_reshard_tree_blocks_equal_reference(runs, mesh):
    reference, port, _ = runs
    for r in port:
        coord = r["coord"][mesh]
        assert set(r["place"][mesh]) == set(reference["place"][mesh])
        for path, blocks in reference["place"][mesh].items():
            assert r["place"][mesh][path] == blocks[coord], (path, coord)


def test_checkpoint_restores_on_another_mesh(runs):
    """The reference's elastic case: written from one mesh (``DTensor``s
    gathered, rank 0 writes), restored sharded onto another."""
    reference, port, _ = runs
    mesh = K.ELASTIC[1]
    for r in port:
        coord = r["coord"][mesh]
        for path, blocks in reference["elastic"].items():
            assert r["elastic"][path] == blocks[coord], (path, coord)


def test_reference_checkpoint_restores_sharded(runs):
    reference, port, _ = runs
    for r in port:
        coord = r["coord"][K.RESTORE_MESH]
        assert r["restore_extra"] == {"step": 3}
        for path, blocks in reference["restore"].items():
            assert r["restore"][path] == blocks[coord], (path, coord)


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #
def test_flash_decode_combine_equals_full_softmax_and_reference(runs):
    """Each of 4 ranks holds a quarter of the KV cache; the combined answer
    is full softmax attention's within 1e-5, and the reference's
    ``shard_map`` answer on 4 host devices within 1e-5."""
    reference, port, inputs = runs
    f = K.FLASH
    q, k, v = (inputs[n].astype(np.float64) for n in ("q", "k", "v"))
    s = np.einsum("bhqd,bhtd->bhqt", q, k) * f["d"] ** -0.5
    s = np.where(np.arange(f["t"]) <= f["cur_len"], s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqt,bhtd->bhqd", w / w.sum(-1, keepdims=True), v)
    for r in port:
        got = np.array(r["flash"]).reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, reference["flash"], rtol=0, atol=1e-5)


def test_pipeline_stage_step_equals_reference_ring(runs):
    reference, port, inputs = runs
    for rank, r in enumerate(port):
        got = np.array(r["ring"], np.float32).reshape(1, 3, 5)
        np.testing.assert_array_equal(got, reference["ring"][rank:rank + 1])
        np.testing.assert_array_equal(got, inputs["ring"][rank - 1:rank or None][:1] * 2 + 1)


def test_distributed_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.distributed, repro_torch.launch.mesh, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
