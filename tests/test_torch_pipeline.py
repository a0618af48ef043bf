"""The port's token pipeline (``repro_torch.data.pipeline``) vs the JAX
package's, on the CPU.

* Batches, source rows and global batches are bit-equal to the
  reference's at 1 and 4 data shards, step after step (numpy on both
  sides: tolerance 0).
* ``state_dict`` round-trips: a restored pipeline yields the next batch.
* Lineage: each package's pipeline logs into its own ``DSLog`` (the port's
  with ``device="cpu"``); backward queries from the shard cells through
  the batch to the corpus give the same boxes, byte for byte, and the
  numpy oracle's cells; the reuse decisions of every op are the same
  (``shard_slice`` is served by ``gen_sig`` reuse from the second step).
"""

import numpy as np
import pytest

from repro.core.catalog import DSLog as JDSLog
from repro.data.pipeline import PipelineConfig as JConfig, TokenPipeline as JPipeline
from repro_torch.core import DSLog as TDSLog
from repro_torch.data import PipelineConfig, TokenPipeline

CFG = dict(vocab=151936, seq_len=32, global_batch=8, seed=7)


@pytest.mark.parametrize("shards", [1, 4])
def test_batches_bit_equal_reference(shards):
    for k in range(shards):
        j = JPipeline(JConfig(**CFG), data_shards=shards, shard_id=k)
        t = TokenPipeline(PipelineConfig(**CFG), data_shards=shards, shard_id=k)
        for step in range(3):
            np.testing.assert_array_equal(t.source_rows_for_step(step),
                                          j.source_rows_for_step(step))
            tg, jg = t.global_batch_tokens(step), j.global_batch_tokens(step)
            assert tg.dtype == jg.dtype == np.int32 and tg.tobytes() == jg.tobytes()
            tb, jb = t.next_batch(), j.next_batch()
            assert tb["step"] == jb["step"] == step
            assert tb["tokens"].tobytes() == jb["tokens"].tobytes()
            assert tb["tokens"].shape == (8 // shards, 32)


def test_global_stream_is_independent_of_sharding():
    cfg = PipelineConfig(**CFG)
    whole = TokenPipeline(cfg).global_batch_tokens(2)
    parts = np.concatenate([TokenPipeline(cfg, 4, k).shard_slice(2) for k in range(4)])
    np.testing.assert_array_equal(whole, parts)
    assert not np.array_equal(whole, TokenPipeline(cfg).global_batch_tokens(3))


def test_state_dict_round_trips():
    cfg = PipelineConfig(vocab=100, seq_len=8, global_batch=4)
    p = TokenPipeline(cfg)
    p.next_batch()
    p.next_batch()
    state = p.state_dict()
    assert state == {"step": 2}
    q = TokenPipeline(cfg)
    q.load_state_dict(state)
    np.testing.assert_array_equal(p.next_batch()["tokens"], q.next_batch()["tokens"])
    assert q.step == 3


@pytest.mark.parametrize("shards", [1, 2])
def test_lineage_equals_reference(shards):
    kw = dict(vocab=1000, seq_len=16, global_batch=8, n_source_rows=256, seed=3)
    jlog, tlog = JDSLog(), TDSLog(device="cpu")
    j = JPipeline(JConfig(**kw), data_shards=shards, shard_id=0, dslog=jlog)
    t = TokenPipeline(PipelineConfig(**kw), data_shards=shards, shard_id=0, dslog=tlog)
    per = 8 // shards
    for step in range(3):
        j.next_batch()
        t.next_batch()
        rows = t.source_rows_for_step(step)
        cells = np.array([[r, c] for r in range(per) for c in (0, 5, 15)])
        for k in range(shards):
            path = [f"shard_s{step}_k{k}", f"batch_s{step}", "corpus"]
            got, want = tlog.prov_query(path, cells), jlog.prov_query(path, cells)
            assert got.lo.tobytes() == want.lo.tobytes()
            assert got.hi.tobytes() == want.hi.tobytes()
            oracle = {(int(rows[k * per + r]), int(c)) for r, c in cells}
            assert got.cell_set() == oracle
    assert [(o.op_name, o.reused) for o in tlog.ops] == [
        (o.op_name, o.reused) for o in jlog.ops]
    assert [o.reused for o in tlog.ops if o.op_name == "shard_slice"][-1] == "dim"
    assert sorted(tlog.arrays) == sorted(jlog.arrays)
