"""The operations and bytes of the kernels and of whole steps, from shapes.

Frozen with the benchmark as its yardstick. A kernel's count is the work
its inputs need (``chip_smoke.py``'s ``_attn_time_cases`` method): 4 * D
operations per visible (query, key) pair and head for an attention forward
(QK^T and PV), 10 * D for its backward (QK^T again, dV, dP, dQ, dK); each
input byte read once and each output byte written once, whatever a kernel
reads again. D is the model's head dim, not the kernel's padded width. A
query at position i sees the keys i - w + 1 .. i under a sliding window of
w, and 0 .. i without one.

A step's model operations count every matmul of every layer and of the
head, and attention over the visible pairs, as the algorithm needs them:
a training step forward and backward (3x the forward), nothing recomputed.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: compute or memory, the larger."""
    return max(flops / PEAKS["bf16_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def visible_pairs(s: int, window: int | None = None) -> int:
    """Visible (query, key) pairs of a causal prefill of s tokens."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def visible(pos: int, window: int | None = None) -> int:
    """Keys a query at position ``pos`` sees."""
    return pos + 1 if window is None else min(pos + 1, window)


def flash_fwd(b: int, s: int, h: int, kv: int, d: int, elt: int = 2,
              window: int | None = None):
    """(flops, bytes) of a causal prefill forward: q in, o out, k and v in."""
    flops = 4 * d * visible_pairs(s, window) * b * h
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * elt
    return flops, nbytes


def flash_bwd(b: int, s: int, h: int, kv: int, d: int, elt: int = 2,
              window: int | None = None):
    """(flops, bytes) of its backward: q, o, dO in and dQ out; k, v in and
    dK, dV out; the rows' float32 log-sum-exp in."""
    flops = 10 * d * visible_pairs(s, window) * b * h
    nbytes = (4 * b * s * h * d + 4 * b * s * kv * d) * elt + 4 * b * h * s
    return flops, nbytes


def decode(b: int, t: int, valid: int, h: int, kv: int, d: int, elt: int = 2):
    """(flops, bytes) of one decode-attention call over a cache of t slots:
    the valid K/V slots, the query and the output, and the (t,) bool mask."""
    flops = 4 * d * valid * b * h
    nbytes = (2 * b * valid * kv * d + 2 * b * h * d) * elt + t
    return flops, nbytes


def cache_slots(cfg: dict, max_len: int) -> int:
    """Slots of a layer's KV cache: the whole length, or the window's ring."""
    w = cfg["sliding_window"]
    return max_len if w is None else min(w, max_len)


def _layer(cfg: dict) -> dict:
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    out = {"attn": d * h * hd + 2 * d * kv * hd + h * hd * d, "norms": 2 * d,
           "mlp": 3 * d * cfg["intermediate_size"]}
    if cfg.get("qk_norm"):
        out["norms"] += 2 * hd
    return out


def _matmul(cfg: dict) -> int:
    """Matmul weights one token multiplies, per layer."""
    lay = _layer(cfg)
    return lay["attn"] + lay["mlp"]


def train_step_flops(cfg: dict, b: int, s: int) -> int:
    """Model operations of one training step of b x s tokens."""
    n_layers, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    hd, h = cfg["head_dim"], cfg["num_attention_heads"]
    fwd = 2 * b * s * (n_layers * _matmul(cfg) + d * v) \
        + 4 * hd * h * visible_pairs(s, cfg["sliding_window"]) * b * n_layers
    return 3 * fwd


def decode_step(cfg: dict, b: int, valid: int):
    """(flops, bytes) of one decode step of b tokens, each seeing ``valid``
    cache slots: every weight read once, the embedding rows, the valid K/V
    read and the new K/V written."""
    n_layers, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    hd, h, kv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    elt = ELT[cfg["torch_dtype"]]
    lay = _layer(cfg)
    flops = 2 * b * (n_layers * _matmul(cfg) + d * v) \
        + 4 * hd * h * valid * b * n_layers
    wbytes = n_layers * ((lay["attn"] + lay["mlp"]) * elt + lay["norms"] * 4) \
        + d * v * elt + d * 4 + b * d * elt
    kv_bytes = n_layers * (2 * b * valid * kv * hd + 2 * b * kv * hd) * elt
    return flops, wbytes + kv_bytes
