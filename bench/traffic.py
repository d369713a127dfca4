"""The general traffic generator: every batch a mix file asks for, made
from the run's seed.

A mix (``bench/traffic/<name>.json``) names its ``kind`` and the sizes of
its batches. Every batch has the same sizes, whatever the seed: the seed
changes only which tokens are drawn. Batch ``k`` of a run is drawn from a
generator seeded with (seed, purpose, k), so it is the same however many
batches came before it.
"""
from __future__ import annotations

import hashlib

import numpy as np


def rng(seed: int, purpose: str, k: int = 0) -> np.random.Generator:
    digest = hashlib.sha256(f"{seed}:{purpose}:{k}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def prompts(mix: dict, vocab: int, seed: int, k) -> np.ndarray:
    """Serving batch ``k`` ("warmup" for the set-up's): (batch, prompt_len)
    token ids, uniform over the vocabulary."""
    return rng(seed, "prompts", k).integers(
        0, vocab, (mix["batch"], mix["prompt_len"]), dtype=np.int32)


def train_batch(mix: dict, vocab: int, seed: int, k: int):
    """Training step ``k``'s (tokens, labels), each (batch, seq_len): a
    sequence of seq_len + 1 uniform ids per row, the labels its next
    tokens."""
    seq = rng(seed, "train", k).integers(
        0, vocab, (mix["batch"], mix["seq_len"] + 1), dtype=np.int32)
    return seq[:, :-1].copy(), seq[:, 1:].copy()


def sample(seed: int, n_total: int, n: int) -> list[int]:
    """``n`` distinct indices out of ``n_total``, drawn from the seed."""
    return sorted(rng(seed, "check").choice(n_total, size=min(n, n_total),
                                            replace=False).tolist())
