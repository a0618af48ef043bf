"""The cases ``test_torch_distributed.py`` runs in both packages: meshes of
4 devices (4 host devices for the reference, 4 ``gloo`` ranks for the
port), architectures, batches, caches and activation hints.  Plain data,
imported by the reference's subprocess (JAX) and the port's ranks (torch)
alike; specs travel as JSON (``None``, a name, or a list of names)."""

WORLD = 4
MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "pod2x2x1": ((2, 2, 1), ("pod", "data", "model")),
    "pod2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}
ARCHS = ("qwen1.5-110b", "qwen1.5-32b", "gemma3-4b", "qwen2-0.5b", "hubert-xlarge",
         "grok-1-314b", "qwen2-moe-a2.7b", "internvl2-2b", "hymba-1.5b", "mamba2-780m")
# (name, arch, seq_len, global batch, kind) of input_specs' batches
BATCHES = (
    ("decoder", "qwen2-0.5b", 64, 8, "train"),
    ("decoder_b1", "qwen2-0.5b", 64, 1, "train"),
    ("patch", "internvl2-2b", 1024, 4, "train"),
    ("frames", "hubert-xlarge", 64, 4, "train"),
    ("decode", "qwen2-0.5b", 64, 4, "decode"),
)
# (arch, batch, max_len, reduced) of init_caches' trees: KV, SSM and conv
# caches, batch 1 (the sequence-parallel cache) and batches the data axes
# do and do not divide
CACHES = tuple((arch, b, 32, red)
               for arch in ("qwen2-0.5b", "qwen1.5-32b", "mamba2-780m", "hymba-1.5b")
               for b in (1, 2, 3, 4) for red in (True, False))
POLICIES = ("auto", "tp_uneven", "seq", "batch_only")
# (kind, shape): every branch of hint (b_ok, tp_ok, seq_ok, uneven heads)
HINTS = (
    ("hidden", (4, 8, 16)), ("hidden", (1, 8, 16)),
    ("heads", (4, 8, 4, 2)), ("heads", (4, 8, 3, 2)), ("heads", (4, 8, 1, 2)),
    ("heads", (4, 7, 3, 2)), ("heads", (4, 1, 3, 2)), ("heads", (1, 8, 4, 2)),
    ("bhst", (4, 4, 8, 8)), ("bhst", (4, 3, 8, 8)), ("bhst", (4, 1, 8, 8)),
    ("bhst", (4, 3, 7, 8)), ("bhst", (4, 3, 1, 8)), ("bhst", (1, 4, 8, 8)),
    ("ffn", (4, 8, 6)), ("ffn", (4, 8, 5)), ("ffn", (1, 8, 6)),
    ("logits", (4, 8, 8)), ("logits", (4, 8, 7)),
    ("experts", (4, 4, 2, 8)), ("experts", (4, 1, 2, 8)),
)
HINT_MESHES = ("2x2", "4x1", "1x4", "pod2x2x1")
# reshard_tree of the reduced qwen2 tree; the elastic case (written on one
# mesh, restored on another); a reference checkpoint restored sharded
PLACE_MESHES = ("2x2", "4x1", "1x4", "pod2x2x1")
ELASTIC = ("4x1", "2x2")
RESTORE_MESH = "2x2"
# flash-decode: [B, H, T, hd] keys split 4 ways along T, valid up to CUR_LEN
FLASH = dict(b=2, h=4, t=64, d=16, cur_len=49)


def hint_key(mesh, policy, kind, shape) -> str:
    return f"{mesh}|{policy}|{kind}|{'x'.join(map(str, shape))}"


def spec_json(spec) -> list:
    """A spec (tuple or ``PartitionSpec``) as JSON."""
    return [e if e is None or isinstance(e, str) else list(e) for e in tuple(spec)]


def flat(tree, prefix="") -> dict:
    """``{"a/b/c": leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat(flat_tree: dict) -> dict:
    """The nested dict of ``{"a/b/c": leaf}``."""
    out: dict = {}
    for path, leaf in flat_tree.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def block(index, shape) -> list:
    """``[[start, stop], ...]`` of a tuple of slices over ``shape``."""
    return [list(s.indices(n)[:2]) for s, n in zip(index, shape)]

# data-parallel and mesh training: the global batch, the steps held to the
# reference and the optimizer (test_torch_dp_train.py, test_torch_tp_*.py)
DP_SEQ, DP_BATCH, DP_STEPS = 16, 4, 3
DP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
# the reference's own jitted step on a (2, 2) mesh: (arch, n_micro), an MoE's
# n_micro the mesh's data size (each data rank's router sees its block)
TP_MESH_STEP = (("qwen2-0.5b", 1), ("qwen2-moe-a2.7b", 2))
TP_MESHES = ("2x2", "1x4", "4x1")
# the vocab-parallel layer cases on a (1, 2) mesh: (arch, changes to its
# reduced() config, MoE dispatch); vocab 250 pads to 256, ids 250-255 in
# model rank 1's half; "cut_heads" has 3 query heads of 16, which 2 model
# ranks cut, so its attention computes whole on both; "moe_sorted" splits
# the experts' F under the gather/scatter dispatch
TP2_VOCAB = 250
TP2_LM = {"tied": ("qwen2-0.5b", {}, None), "untied": ("qwen1.5-32b", {}, None),
          "cut_heads": ("qwen2-0.5b", {"n_heads": 3, "n_kv_heads": 1, "head_dim": 16}, None),
          "moe_sorted": ("qwen2-moe-a2.7b", {}, "sorted")}


def tp2_cfg(configs, name):
    """``TP2_LM[name]``'s config from either package's ``configs``."""
    import dataclasses

    arch, changes, dispatch = TP2_LM[name]
    cfg = dataclasses.replace(configs.get_arch(arch).reduced(), vocab=TP2_VOCAB, **changes)
    if dispatch is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return cfg
