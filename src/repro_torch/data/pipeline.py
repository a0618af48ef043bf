"""Deterministic, shardable, checkpointable synthetic token pipeline.

The port of ``repro.data.pipeline``: the same batches, bit for bit (numpy
throughout), logging its lineage into the port's ``DSLog`` on the device
that store was opened on.

Design: the batch for (seed, step, shard) is a *pure function* — no iterator
state beyond the step counter.  That gives us, for free:

* **checkpoint/restart**: the pipeline state is one integer in the train
  checkpoint;
* **elasticity**: re-sharding to a different data-parallel size replays the
  same global batch split differently (bitwise-identical global stream);
* **fine-grained lineage**: every pipeline stage (source rows → shuffle →
  shard → microbatch) is an index-arithmetic array op whose lineage DSLog
  compresses to O(1) rows and reuses per step via ``gen_sig`` (the paper's
  reuse case is *exactly* the per-step repetition of these ops).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.capture import slice_lineage, take_lineage
from ..core.catalog import DSLog
from ..core.relation import LineageRelation

__all__ = ["PipelineConfig", "TokenPipeline"]


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_source_rows: int = 1 << 20  # synthetic corpus size (documents)


class TokenPipeline:
    """Yields per-shard token batches; optionally logs lineage into DSLog."""

    def __init__(
        self,
        cfg: PipelineConfig,
        data_shards: int = 1,
        shard_id: int = 0,
        dslog: DSLog | None = None,
    ):
        assert cfg.global_batch % data_shards == 0
        self.cfg = cfg
        self.data_shards = data_shards
        self.shard_id = shard_id
        self.dslog = dslog
        self.step = 0

    # ------------------------------------------------------------------ #
    def source_rows_for_step(self, step: int) -> np.ndarray:
        """Global document ids consumed at ``step`` (the shuffle)."""
        rng = np.random.default_rng((self.cfg.seed, step))
        return rng.choice(
            self.cfg.n_source_rows, size=self.cfg.global_batch, replace=False
        )

    def global_batch_tokens(self, step: int) -> np.ndarray:
        rows = self.source_rows_for_step(step)
        # tokens are a pure hash of (document id, position): reproducible
        pos = np.arange(self.cfg.seq_len, dtype=np.uint64)
        mixed = (rows[:, None].astype(np.uint64) * np.uint64(6364136223846793005)
                 + pos[None, :] * np.uint64(1442695040888963407))
        mixed ^= mixed >> np.uint64(33)
        return (mixed % np.uint64(self.cfg.vocab)).astype(np.int32)

    def shard_slice(self, step: int) -> np.ndarray:
        g = self.global_batch_tokens(step)
        per = self.cfg.global_batch // self.data_shards
        return g[self.shard_id * per : (self.shard_id + 1) * per]

    # ------------------------------------------------------------------ #
    def next_batch(self) -> dict:
        step = self.step
        tokens = self.shard_slice(step)
        if self.dslog is not None:
            self._log_lineage(step)
        self.step += 1
        return {"tokens": tokens, "step": step}

    # ------------------------------------------------------------------ #
    # checkpointing: state is just the step counter
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    # ------------------------------------------------------------------ #
    def _log_lineage(self, step: int) -> None:
        """Register this step's pipeline ops in DSLog.

        Chain per step s:  corpus → batch_s (gather of shuffled rows)
                           batch_s → shard_s_k (slice per data shard)
        The gather is value-dependent (different rows each step: base_sig
        only), but the slice/microbatch ops repeat identically and are
        served by gen_sig reuse after the first step.
        """
        cfg = self.cfg
        log = self.dslog
        rows = self.source_rows_for_step(step)
        corpus = "corpus"
        batch = f"batch_s{step}"
        if corpus not in log.arrays:
            log.define_array(corpus, (cfg.n_source_rows, cfg.seq_len))
        log.define_array(batch, (cfg.global_batch, cfg.seq_len))
        log.register_operation(
            "batch_gather",
            [corpus],
            [batch],
            capture=lambda: {
                (0, 0): take_lineage(
                    (cfg.n_source_rows, cfg.seq_len), rows, 0
                )
            },
            op_args={"step": step},
            reuse=False,  # shuffle is step-dependent: never reusable
        )
        per = cfg.global_batch // self.data_shards
        for k in range(self.data_shards):
            shard = f"shard_s{step}_k{k}"
            log.define_array(shard, (per, cfg.seq_len))
            start = k * per
            log.register_operation(
                "shard_slice",
                [batch],
                [shard],
                capture=lambda start=start, per=per: {
                    (0, 0): _slice_rows(
                        (cfg.global_batch, cfg.seq_len), start, per
                    )
                },
                op_args={"k": k, "of": self.data_shards},
            )


def _slice_rows(shape, start, count) -> LineageRelation:
    return slice_lineage(shape, (start, 0), (start + count, shape[1]))
