"""Dense MLP (gated SiLU or plain GeLU). Port of the dense half of
``repro/models/mlp.py``; the Mixture-of-Experts half waits for the slice
that serves an MoE config."""
from __future__ import annotations

import torch

from repro_torch.models.common import activate, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> dict:
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }
    if act == "silu":  # gated (SwiGLU)
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = activate(x @ p["w_gate"], act) * h
    else:
        h = activate(h, act)
    return h @ p["w_down"]
