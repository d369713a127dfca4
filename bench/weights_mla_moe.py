"""The benchmark's weights of an MLA + DeepSeekMoE model (DeepSeek-V2):
the leaves of ``bench/configs/deepseek-v2-lite.json``, drawn on the device
from ``--seed`` by ``weights.draw`` (a leaf with a leading layer axis slice
by slice, so any layer can be drawn again alone, in the same bits).

Leaf names: ``embed``, ``lm_head``, ``final_norm.scale``; over every layer
``layers.norm1.scale``, ``layers.attn.{wq, wkv_a, kv_norm.scale, wkv_b,
wo}`` and ``layers.norm2.scale``; over the ``first_k_dense_replace`` dense
layers ``layers.mlp.{w_gate, w_up, w_down}``; over the MoE layers after
them ``layers.moe.router`` (float32), ``layers.moe.{w_gate, w_up,
w_down}`` (the routed experts stacked, (E, in, out) a layer) and
``layers.moe.shared.{w_gate, w_up, w_down}`` (the shared experts as one
MLP of n_shared x moe_intermediate_size). A leaf's layer index counts its
own layers: ``layers.moe.*`` slice j is model layer first_k_dense_replace
+ j.

Matrices are N(0, 1/fan_in) (an expert's own fan-in), the embedding and the
head N(0, 0.02^2), the router N(0, 1/hidden_size) in float32, norm scales
1 + N(0, 0.1^2) in float32; matrices in the configuration's
``torch_dtype``.
"""
from __future__ import annotations

from bench import weights


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, str, str]]:
    """(name, shape, dtype name, init) of every leaf, in a fixed order."""
    d, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    h, dn, dr, dv, lat = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                          cfg["kv_lora_rank"])
    k_dense, e = cfg["first_k_dense_replace"], cfg["n_routed_experts"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = fe * cfg["n_shared_experts"]
    dt = cfg["torch_dtype"]
    if cfg["q_lora_rank"] is not None:
        raise ValueError("bench/weights_mla_moe.py draws q without "
                         "compression (q_lora_rank null) only")

    def normal(fan_in):
        return f"normal:{fan_in ** -0.5}"

    out = [("embed", (v, d), dt, "normal:0.02")]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, v), dt, "normal:0.02"))
    out.append(("final_norm.scale", (d,), "float32", "scale"))
    every = [("layers.norm1.scale", (d,), "float32", "scale"),
             ("layers.attn.wq", (d, h * (dn + dr)), dt, normal(d)),
             ("layers.attn.wkv_a", (d, lat + dr), dt, normal(d)),
             ("layers.attn.kv_norm.scale", (lat,), "float32", "scale"),
             ("layers.attn.wkv_b", (lat, h * (dn + dv)), dt, normal(lat)),
             ("layers.attn.wo", (h * dv, d), dt, normal(h * dv)),
             ("layers.norm2.scale", (d,), "float32", "scale")]
    dense = [("layers.mlp.w_gate", (d, f), dt, normal(d)),
             ("layers.mlp.w_up", (d, f), dt, normal(d)),
             ("layers.mlp.w_down", (f, d), dt, normal(f))]
    moe = [("layers.moe.router", (d, e), "float32", normal(d)),
           ("layers.moe.w_gate", (e, d, fe), dt, normal(d)),
           ("layers.moe.w_up", (e, d, fe), dt, normal(d)),
           ("layers.moe.w_down", (e, fe, d), dt, normal(fe))]
    if fs:
        moe += [("layers.moe.shared.w_gate", (d, fs), dt, normal(d)),
                ("layers.moe.shared.w_up", (d, fs), dt, normal(d)),
                ("layers.moe.shared.w_down", (fs, d), dt, normal(fs))]
    for count, group in ((n, every), (k_dense, dense), (n - k_dense, moe)):
        out += [(name, (count, *shape), dtn, init)
                for name, shape, dtn, init in group]
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """Every leaf, whole, on ``device``."""
    return {spec[0]: weights.draw(spec, seed, device)
            for spec in leaf_specs(cfg)}


def drawer(cfg: dict, seed: int, device):
    """``W(name, layer)``: a leaf (``layer`` None) or one layer's slice,
    drawn again in float32."""
    specs = {s[0]: s for s in leaf_specs(cfg)}
    return lambda name, layer: weights.draw(specs[name], seed, device,
                                            layer).float()
