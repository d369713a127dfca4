"""The plain reference of DeepSeek-V2 (MLA and DeepSeekMoE), as the
benchmark runs DeepSeek-V2-Lite.

Plain PyTorch in float32 (TF32 off, ``model.fp32_matmuls``), written from
the configuration file and Hugging Face's ``modeling_deepseek``
(``DeepseekV2ForCausalLM``): token embedding, then per layer an RMSNorm,
multi-head latent attention and a residual add, an RMSNorm and an MLP and a
residual add, then a final RMSNorm and the head. It imports nothing of the
program. Weights come from an accessor ``W(name, layer)`` that returns
float32 tensors (``bench/weights_mla_moe.py`` leaf names; a leaf's layer
index counts its own layers).

* Attention in the non-absorbed order: q = x W_q (no q compression where
  ``q_lora_rank`` is null), the compressed kv c = RMSNorm((x W_kva)[:512])
  and the shared rope key (x W_kva)[512:], k_nope and v from c W_kvb; the
  rope parts rotated by halves (the published checkpoint's interleaved
  columns, which modeling_deepseek permutes before ``rotate_half``, are a
  fixed permutation of drawn weights, left out here), k's rope part shared
  by the heads, causal softmax at the scale below, one row and one block of
  queries at a time.
* YaRN as ``DeepseekV2YarnRotaryEmbedding`` computes it: the pairs below
  the correction range keep base ``rope_theta``, those from its top up are
  divided by ``factor``, with a linear ramp between; cos and sin times
  mscale(mscale) / mscale(mscale_all_dim); the softmax scale
  (nope + rope)^-0.5 times mscale(mscale_all_dim)^2, mscale(m) = 0.1 m
  ln(factor) + 1.
* The first ``first_k_dense_replace`` layers a SwiGLU MLP; then DeepSeekMoE:
  a float32 softmax router over the routed experts, the top
  ``num_experts_per_tok`` (greedy), their probabilities as gates (divided
  by their sum under ``norm_topk_prob``, else times
  ``routed_scaling_factor``), every chosen expert computed (no capacity),
  and the shared experts added.

``held``: the routing to hold the forward to, (MoE layers, R, T, k)
expert ids (the program's record, or the control's choices). A held
layer computes the experts given, each with the reference's own float32
probability as its gate; its own top-k are still returned, to count where
the two disagree.

``precision="fp8"`` is the control, as ``model.py``'s: every projection
(attention, MLP, experts, head) in float8 e4m3 with one scale per tensor;
the router, norms and softmax stay in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.model import Q_BLOCK, linear, rmsnorm


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg: dict, device):
    """(inverse frequencies (rope_dim / 2,), factor on cos and sin)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    rs = cfg["rope_scaling"]
    if rs is None:
        return extra, 1.0
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inter = 1.0 / (factor * base ** exps)
    inv_freq = inter * (1 - mask) + extra * mask
    return inv_freq, _mscale(factor, rs["mscale"]) / _mscale(factor,
                                                              rs["mscale_all_dim"])


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs is not None and rs.get("mscale_all_dim"):
        m = _mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x, pos, inv_freq, m: float):
    """x (R, T, heads, D), rotated by halves at positions ``pos`` (T,)."""
    freqs = torch.outer(pos.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = (emb.cos() * m)[:, None, :], (emb.sin() * m)[:, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def attention(q, k, v, scale: float):
    """q, k (R, T, H, Dqk), v (R, T, H, Dv) -> (R, T, H, Dv), causal."""
    r, t = q.shape[:2]
    rows = []
    for i in range(r):
        blocks = []
        for q0 in range(0, t, Q_BLOCK):
            q1 = min(t, q0 + Q_BLOCK)
            s = torch.einsum("qhd,khd->hqk", q[i, q0:q1], k[i, :q1]) * scale
            hide = torch.arange(q1, device=q.device)[None, :] \
                > torch.arange(q0, q1, device=q.device)[:, None]
            s = s.masked_fill(hide[None], float("-inf"))
            blocks.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                       v[i, :q1]))
        rows.append(torch.cat(blocks, dim=0))
    return torch.stack(rows)


def mla(x, cfg: dict, W, layer: int, precision: str, tables):
    r, t, _ = x.shape
    h, dn, dr, dv, lat = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                          cfg["kv_lora_rank"])
    pos = torch.arange(t, device=x.device)
    q = linear(x, W("layers.attn.wq", layer), precision).view(r, t, h, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = linear(x, W("layers.attn.wkv_a", layer), precision).split(
        [lat, dr], dim=-1)
    c = rmsnorm(c, W("layers.attn.kv_norm.scale", layer), cfg["rms_norm_eps"])
    kv = linear(c, W("layers.attn.wkv_b", layer), precision).view(r, t, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    inv_freq, m = tables
    q_pe = rope(q_pe, pos, inv_freq, m)
    k_pe = rope(k_pe[:, :, None, :], pos, inv_freq, m).expand(r, t, h, dr)
    o = attention(torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1),
                  v, softmax_scale(cfg))
    return linear(o.reshape(r, t, h * dv), W("layers.attn.wo", layer), precision)


def swiglu(h, wg, wu, wd, precision: str):
    return linear(F.silu(linear(h, wg, precision)) * linear(h, wu, precision),
                  wd, precision)


def moe(h, cfg: dict, W, j: int, precision: str, held=None):
    """MoE layer j (its own index) over h (R, T, d). Returns (y, own top-k
    (R, T, k), deficit (R, T, k): the k-th largest router logit less the
    logit of each computed choice, > 0 where it lies below the own top-k)."""
    r, t, d = h.shape
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    x = h.reshape(-1, d)
    logits = x @ W("layers.moe.router", j)
    probs = torch.softmax(logits, dim=-1)
    top = logits.topk(k, dim=-1)
    use = top.indices if held is None else held.reshape(-1, k).to(x.device)
    gates = probs.gather(-1, use)
    if cfg["norm_topk_prob"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    else:
        gates = gates * cfg["routed_scaling_factor"]
    wg, wu, wd = (W(f"layers.moe.{n}", j) for n in ("w_gate", "w_up", "w_down"))
    y = torch.zeros_like(x)
    for i in range(e):
        tok, slot = (use == i).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], wg[i], wu[i], wd[i], precision)
            y.index_add_(0, tok, out * gates[tok, slot, None])
    del wg, wu, wd
    if cfg["n_shared_experts"]:
        y = y + swiglu(x, *(W(f"layers.moe.shared.{n}", j)
                            for n in ("w_gate", "w_up", "w_down")), precision)
    deficit = top.values[:, -1:] - logits.gather(-1, use)
    return (y.view(r, t, d), top.indices.view(r, t, k),
            deficit.view(r, t, k))


def forward(tokens, cfg: dict, W, precision: str = "fp32", held=None):
    """tokens (R, T) -> (final normed hidden (R, T, d), own top-k per MoE
    layer (n_moe, R, T, k), deficits (n_moe, R, T, k))."""
    eps, k_dense = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    tables = rope_tables(cfg, tokens.device)
    x = W("embed", None)[tokens]
    own, deficit = [], []
    for layer in range(cfg["num_hidden_layers"]):
        x = x + mla(rmsnorm(x, W("layers.norm1.scale", layer), eps), cfg, W,
                    layer, precision, tables)
        h = rmsnorm(x, W("layers.norm2.scale", layer), eps)
        if layer < k_dense:
            x = x + swiglu(h, *(W(f"layers.mlp.{n}", layer)
                                for n in ("w_gate", "w_up", "w_down")), precision)
            continue
        j = layer - k_dense
        y, o, dfc = moe(h, cfg, W, j, precision,
                        None if held is None else held[j])
        x = x + y
        own.append(o)
        deficit.append(dfc)
    return (rmsnorm(x, W("final_norm.scale", None), eps), torch.stack(own),
            torch.stack(deficit))


@torch.no_grad()
def served_logits(prompts, served, cfg: dict, W, precision: str = "fp32",
                  held=None):
    """The logits from which each served token was chosen: prompts (R, P)
    and served (R, G) -> ((R, G, vocab), own top-k (n_moe, R, P+G-1, k),
    deficits (n_moe, R, P+G-1, k)): the head at positions P-1 .. P+G-2 of
    prompt + served[:, :-1]."""
    p, g = prompts.shape[1], served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1)
    x, own, deficit = forward(tokens, cfg, W, precision, held)
    head = W("embed", None).T if cfg["tie_word_embeddings"] else W("lm_head", None)
    return linear(x[:, p - 1:p + g - 1], head, precision), own, deficit
