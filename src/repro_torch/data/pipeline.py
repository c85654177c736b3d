"""Deterministic, shardable, resumable data pipeline (port of
``repro/data/pipeline.py``: the same numpy code, so batches equal the JAX
package's bit for bit).

Every dataset here yields ``{tokens, labels}`` numpy batches and is:

* **deterministic** — batch content is a pure function of ``(seed, step)``,
  so restarts and elastic re-shards reproduce the exact token stream
  (straggler/failure recovery never replays or skips data),
* **sharded** — each host materializes only its ``(shard_id, n_shards)``
  slice of the global batch,
* **resumable** — state is a single integer step (stored in checkpoints).

``SyntheticLM`` is the throughput/dry-run corpus.  ``SyntheticSeq2Task``
generates the *controlled-intrinsic-rank* tasks used to reproduce the
paper's RTE-vs-DROP contrast (§3): a random target map of chosen rank is
planted on the embedding geometry, so "task rank" is an experimental knob.
``pack_documents`` is the standard fixed-length packer for real text.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np

__all__ = ["SyntheticLM", "SyntheticSeq2Task", "PackedDataset", "pack_documents"]


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard])
    )


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic token stream (deterministic per (seed, step))."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_id: int = 0
    n_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.local_batch = self.global_batch // self.n_shards

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step, self.shard_id)
        toks = rng.integers(
            0, self.vocab_size, (self.local_batch, self.seq_len + 1),
            dtype=np.int32,
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class SyntheticSeq2Task:
    """Sequence task with a *planted linear map of controlled rank*.

    Construction: draw prompt tokens; the "answer" token is
    ``argmax_v  e_v . (M @ mean_t e_{x_t})`` where ``M (d_e, d_e)`` has
    exactly ``task_rank`` nonzero singular values and ``e`` is a fixed
    random embedding.  Fitting the task requires the model to internalize
    ``M``: low ``task_rank`` mimics RTE (LoRA suffices), high ``task_rank``
    mimics DROP (high-rank updates needed) — paper §3.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    task_rank: int
    embed_dim: int = 64
    seed: int = 0
    shard_id: int = 0
    n_shards: int = 1
    n_answers: int = 16   # answer tokens live in [0, n_answers)

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.local_batch = self.global_batch // self.n_shards
        rng = np.random.default_rng(self.seed + 7777)
        self.embed = rng.standard_normal((self.vocab_size, self.embed_dim))
        u, _, vt = np.linalg.svd(
            rng.standard_normal((self.embed_dim, self.embed_dim))
        )
        s = np.zeros(self.embed_dim)
        s[: self.task_rank] = np.linspace(2.0, 1.0, self.task_rank)
        self.task_map = (u * s) @ vt

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step, self.shard_id)
        b, s = self.local_batch, self.seq_len
        prompt = rng.integers(
            self.n_answers, self.vocab_size, (b, s - 1), dtype=np.int32
        )
        feat = self.embed[prompt].mean(axis=1) @ self.task_map.T   # (b, d_e)
        answer = np.argmax(
            feat @ self.embed[: self.n_answers].T, axis=-1
        ).astype(np.int32)                                          # (b,)
        tokens = np.concatenate([prompt, answer[:, None]], axis=1)
        labels = np.full_like(tokens, -100)
        labels[:, -1] = answer                  # loss only on the answer slot
        # shift: labels[t] predicts tokens[t+1]; answer sits at the last slot
        labels = np.roll(labels, -1, axis=1)
        labels[:, -1] = -100
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pack_documents(
    docs: Sequence[Sequence[int]], seq_len: int, pad_id: int
) -> np.ndarray:
    """Greedy fixed-length packing of token documents -> (N, seq_len+1)."""
    stream: List[int] = []
    for d in docs:
        stream.extend(d)
    n = max(1, (len(stream)) // (seq_len + 1))
    stream = stream[: n * (seq_len + 1)]
    if not stream:
        stream = [pad_id] * (seq_len + 1)
        n = 1
    return np.asarray(stream, dtype=np.int32).reshape(n, seq_len + 1)


@dataclasses.dataclass
class PackedDataset:
    """Epoch-shuffled, sharded iterator over pre-packed rows."""

    rows: np.ndarray           # (N, seq_len+1)
    global_batch: int
    seed: int = 0
    shard_id: int = 0
    n_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.local_batch = self.global_batch // self.n_shards

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.rows)
        per_epoch = max(1, n // self.global_batch)
        epoch, pos = divmod(step, per_epoch)
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])
        ).permutation(n)
        start = pos * self.global_batch + self.shard_id * self.local_batch
        idx = order[(start + np.arange(self.local_batch)) % n]
        rows = self.rows[idx]
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}
