"""The port's data pipeline (numpy code copied from the JAX package, which
the port may not import) gives the JAX package's batches bit for bit:
every class, several steps, shards and seeds; and the byte tokenizer
round-trips as the JAX one does."""

import numpy as np
import pytest

from repro import data as J
from repro_torch import data as T


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_synthetic_lm_batches_equal(shard):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=3,
              shard_id=shard[0], n_shards=shard[1])
    for step in (0, 1, 17):
        _same(T.SyntheticLM(**kw).batch(step), J.SyntheticLM(**kw).batch(step))


@pytest.mark.parametrize("seed,task_rank", [(0, 8), (5, 2)])
def test_synthetic_seq2_task_batches_equal(seed, task_rank):
    kw = dict(vocab_size=256, seq_len=32, global_batch=16,
              task_rank=task_rank, seed=seed)
    t, j = T.SyntheticSeq2Task(**kw), J.SyntheticSeq2Task(**kw)
    np.testing.assert_array_equal(t.task_map, j.task_map)
    for step in (0, 3, 999):
        _same(t.batch(step), j.batch(step))
    tit, jit = iter(t), iter(j)
    for _ in range(3):
        _same(next(tit), next(jit))


def test_packed_dataset_and_packing_equal():
    tok_t, tok_j = T.ByteTokenizer(), J.ByteTokenizer()
    docs = ["QuanTA fine-tunes high-rank updates.", "héllo wörld", "",
            "x" * 70]
    ids_t = [tok_t.encode(d) for d in docs]
    assert ids_t == [tok_j.encode(d) for d in docs]
    rows_t = T.pack_documents(ids_t, 16, tok_t.PAD)
    rows_j = J.pack_documents(ids_t, 16, tok_j.PAD)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(T.pack_documents([], 8, 258),
                                  J.pack_documents([], 8, 258))
    for shard in ((0, 1), (1, 2)):
        kw = dict(rows=rows_t, global_batch=2, seed=4, shard_id=shard[0],
                  n_shards=shard[1])
        for step in range(5):
            _same(T.PackedDataset(**kw).batch(step),
                  J.PackedDataset(**kw).batch(step))


def test_tokenizer_round_trips():
    tok = T.ByteTokenizer()
    text = "QuanTA — 量子"
    ids = tok.encode(text)
    assert ids[0] == tok.BOS and ids[-1] == tok.EOS
    assert tok.decode(ids) == text == J.ByteTokenizer().decode(ids)
    assert tok.vocab_size == J.ByteTokenizer.vocab_size


def test_uneven_shards_raise():
    with pytest.raises(ValueError):
        T.SyntheticLM(vocab_size=10, seq_len=4, global_batch=3, n_shards=2)
