"""Deterministic sharded synthetic data pipeline (a numpy copy of
``repro/data/synthetic.py``: the same batches, bit for bit).

Every batch is a pure function of (seed, step, shard) — no filesystem, no
state. That determinism is what makes checkpoint-resume and elastic
re-placement exactly reproducible: after a restart the pipeline replays from
the restored step with identical data. Multi-host sharding slices the global
batch by ``shard_id/num_shards`` (each host materializes only its rows).

Batch layouts by family (matches launch.specs.input_specs):
  * lm-like:  {tokens (B,S) i32, labels (B,S) i32}
  * audio:    + frames  (B, S_enc, d_model) activation dtype
  * vlm:      + patches (B, n_patches, vit_dim) activation dtype
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # Independent stream per (seed, step, shard) — replay-stable.
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, shard)))


def make_batch(cfg: ModelConfig, data_cfg: SyntheticConfig, step: int,
               dtype=np.float32) -> dict:
    """One deterministic local batch for `step`."""
    rng = _rng_for(data_cfg.seed, step, data_cfg.shard_id)
    b, s = data_cfg.local_batch, data_cfg.seq_len
    # Markov-ish token stream (not uniform noise: gives a learnable signal
    # so the e2e example's loss visibly decreases).
    base = rng.integers(0, cfg.vocab_size, size=(b, 1), dtype=np.int32)
    drift = rng.integers(0, 17, size=(b, s), dtype=np.int32)
    tokens = (base + np.cumsum(drift, axis=1)) % cfg.vocab_size
    tokens = tokens.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:],
                             np.full((b, 1), -100, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_max_len, cfg.d_model)).astype(dtype)
    elif cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.vit_dim)).astype(dtype)
    return batch


class SyntheticLM:
    """Iterator facade: ``for step, batch in SyntheticLM(...).iter(start)``."""

    def __init__(self, cfg: ModelConfig, data_cfg: SyntheticConfig,
                 dtype=np.float32):
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.dtype = dtype

    def batch_at(self, step: int) -> dict:
        return make_batch(self.cfg, self.data_cfg, step, self.dtype)

    def iter(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1


def batch_struct(cfg: ModelConfig, global_batch: int, seq_len: int,
                 act_dtype=np.float32) -> dict:
    """Shape/dtype skeleton of a *global* batch."""
    out = {
        "tokens": ((global_batch, seq_len), np.int32),
        "labels": ((global_batch, seq_len), np.int32),
    }
    if cfg.family == "audio":
        out["frames"] = ((global_batch, cfg.encoder_max_len, cfg.d_model),
                         act_dtype)
    elif cfg.family == "vlm":
        out["patches"] = ((global_batch, cfg.n_patches, cfg.vit_dim),
                          act_dtype)
    return out
