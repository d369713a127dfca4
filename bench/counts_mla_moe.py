"""The operations and bytes of an MLA + DeepSeekMoE model (DeepSeek-V2)
from its configuration file and the shapes of a call, as ``counts.py``
counts the dense models' (its peaks and ``bound_s``), frozen with the
benchmark as its yardstick.

A prefill's model operations: per token every matmul of every layer with
its own 6 routed and the shared experts (and the router), MLA attention at
2 (Dqk + Dv) per visible (query, key) pair and head (q k^T at nope + rope,
p v at v's width), and the head on the last position only. A decode step
in the absorbed order: per token the projections (q, the compressed kv,
q_nope absorbed into the latent space and the context out of it, the out
projection), 2 (2 L + rope) per valid latent slot and head, the MLPs as in
the prefill and the head; its bytes every dense weight once, each expert
that at least one of the step's tokens chose once, the embedding rows, and
the valid latent slots read (L + rope elements each, a layer) with the new
ones written. D is the model's width, not a kernel's padded one.
"""
from __future__ import annotations

from bench.counts import ELT, PEAKS, bound_s, visible_pairs  # noqa: F401


def _dims(cfg: dict) -> dict:
    return dict(d=cfg["hidden_size"], v=cfg["vocab_size"],
                h=cfg["num_attention_heads"], dn=cfg["qk_nope_head_dim"],
                dr=cfg["qk_rope_head_dim"], dv=cfg["v_head_dim"],
                lat=cfg["kv_lora_rank"], e=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], fe=cfg["moe_intermediate_size"],
                fs=cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
                f=cfg["intermediate_size"], n=cfg["num_hidden_layers"],
                kd=cfg["first_k_dense_replace"])


def _attn_weights(c: dict) -> int:
    """Matmul weights of one layer's attention (q without compression)."""
    return (c["d"] * c["h"] * (c["dn"] + c["dr"]) + c["d"] * (c["lat"] + c["dr"])
            + c["lat"] * c["h"] * (c["dn"] + c["dv"]) + c["h"] * c["dv"] * c["d"])


def _mlp_per_token(c: dict) -> int:
    """Matmul weights a token multiplies in the MLPs of all layers."""
    moe = c["k"] * 3 * c["d"] * c["fe"] + 3 * c["d"] * c["fs"] + c["d"] * c["e"]
    return c["kd"] * 3 * c["d"] * c["f"] + (c["n"] - c["kd"]) * moe


def flash_fwd_mla(cfg: dict, b: int, s: int, elt: int = 2):
    """(flops, bytes) of one layer's causal MLA prefill attention: q and k
    (per head) at nope + rope, v and o at v's width."""
    c = _dims(cfg)
    dqk = c["dn"] + c["dr"]
    flops = 2 * (dqk + c["dv"]) * visible_pairs(s) * b * c["h"]
    nbytes = b * s * c["h"] * (2 * dqk + 2 * c["dv"]) * elt
    return flops, nbytes


def prefill_flops(cfg: dict, b: int, s: int) -> int:
    """Model operations of a prefill of b x s tokens."""
    c = _dims(cfg)
    per_token = c["n"] * _attn_weights(c) + _mlp_per_token(c)
    attn = c["n"] * flash_fwd_mla(cfg, b, s)[0]
    return 2 * b * s * per_token + attn + 2 * b * c["d"] * c["v"]


def decode_step(cfg: dict, b: int, valid: int, hits) -> tuple[int, int]:
    """(flops, bytes) of one absorbed decode step of b tokens over
    ``valid`` latent slots; ``hits``: per MoE layer, the experts the step's
    tokens chose (distinct)."""
    c = _dims(cfg)
    elt = ELT[cfg["torch_dtype"]]
    h, lat, dr = c["h"], c["lat"], c["dr"]
    proj = (c["d"] * h * (c["dn"] + c["dr"]) + c["d"] * (lat + dr)
            + h * c["dn"] * lat + h * lat * c["dv"] + h * c["dv"] * c["d"])
    flops = 2 * b * (c["n"] * proj + _mlp_per_token(c) + c["d"] * c["v"]) \
        + c["n"] * 2 * b * h * valid * (2 * lat + dr)
    expert = 3 * c["d"] * c["fe"] * elt
    weights = (c["n"] * (_attn_weights(c) * elt + (2 * c["d"] + lat) * 4)
               + c["kd"] * 3 * c["d"] * c["f"] * elt
               + (c["n"] - c["kd"]) * (3 * c["d"] * c["fs"] * elt
                                       + c["d"] * c["e"] * 4)
               + expert * sum(hits)
               + c["d"] * c["v"] * elt + c["d"] * 4 + b * c["d"] * elt)
    cache = c["n"] * b * (valid + 1) * (lat + dr) * elt
    return flops, weights + cache
