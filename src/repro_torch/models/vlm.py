"""VLM backbone (InternVL2-style): ViT frontend stub + MLP projector + LM.
Port of ``repro/models/vlm.py``.

The inputs are precomputed InternViT patch embeddings (B, n_patches,
vit_dim) in the config's activation dtype; the projector maps them into the
LM's embedding space and they are prepended to the text tokens. The loss is
taken on text positions only. Decoding is ``decoder_lm``'s: the patches
hold positions 0 .. n_patches - 1, so the first generated token sits at
n_patches + prompt length (``launch/serve.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder_lm as dlm
from repro_torch.models.common import (activate, cross_entropy, dense_init,
                                       generator)

PyTree = Any


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> PyTree:
    """``decoder_lm``'s tree plus ``projector.{w1, w2}``, drawn from one
    generator seeded with ``seed`` on ``device``."""
    dev = _device.resolve(device)
    gen = generator(dev, seed)
    params = dlm.init_params_from(cfg, gen)
    dt = dlm._dtype(cfg)
    params["projector"] = {
        "w1": dense_init(gen, cfg.vit_dim, cfg.d_model, dt),
        "w2": dense_init(gen, cfg.d_model, cfg.d_model, dt),
    }
    return params


def _embed_multimodal(params, cfg: ModelConfig, patches, tokens):
    """(B, P + S, d): the projected patches (tanh gelu, as ``jax.nn.gelu``),
    then the text embeddings."""
    proj = activate(patches @ params["projector"]["w1"], "gelu") \
        @ params["projector"]["w2"]
    text = dlm.embed_lookup(params["embed"], tokens)
    return torch.cat([proj.to(text.dtype), text], dim=1)


def loss_and_metrics(params, cfg: ModelConfig, batch: dict):
    """batch: patches (B, P, vit_dim), tokens (B, S), labels (B, S), tensors
    on the params' device. Returns (loss, {"loss", "ce", "aux"})."""
    embeds = _embed_multimodal(params, cfg, batch["patches"], batch["tokens"])
    logits, aux, _ = dlm.forward(params, cfg, embeds=embeds)
    text_logits = logits[:, batch["patches"].shape[1]:]
    labels = batch["labels"]
    ce = cross_entropy(text_logits, labels.clamp(min=0), (labels >= 0).float())
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, patches, tokens, max_len: int = 0):
    """Returns (logits_last (B, 1, V), caches) over the patches and the
    prompt; ``max_len`` counts the patches."""
    embeds = _embed_multimodal(params, cfg, patches, tokens)
    return dlm.prefill(params, cfg, embeds=embeds, max_len=max_len)


decode_step = dlm.decode_step
