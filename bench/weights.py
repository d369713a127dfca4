"""The benchmark's weights: made on the device from ``--seed``.

A model is a list of named leaves (``leaf_specs``), each drawn slice by
slice from a ``torch.Generator`` on the device: a leaf with a leading layer
axis draws one call per layer, with a generator seeded from the run's seed,
the leaf's name and the layer. So any slice can be drawn again alone, in
the same bits, on the same device: the reference and the training check
draw the initial weights anew instead of keeping a copy.

Matrices are N(0, 1/fan_in), the embedding and the head N(0, 0.02^2) (the
logits then have a standard deviation of about 1), norm scales 1 + N(0,
0.1^2) in float32. Matrices are stored in the configuration's
``torch_dtype``.

Leaf names: ``embed``, ``lm_head``, ``final_norm.scale`` and
``layers.<part>.<name>`` with a leading (num_hidden_layers,) axis.
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, str, str]]:
    """(name, shape, dtype name, init) of every leaf, in a fixed order.
    ``init`` is ``"normal:<std>"`` or ``"scale"`` (1 + N(0, 0.1^2))."""
    d, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    dt = cfg["torch_dtype"]
    out = [("embed", (v, d), dt, "normal:0.02")]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, v), dt, "normal:0.02"))
    out.append(("final_norm.scale", (d,), "float32", "scale"))
    lay = [("layers.norm1.scale", (d,), "float32", "scale"),
           ("layers.attn.wq", (d, h * hd), dt, f"normal:{d ** -0.5}"),
           ("layers.attn.wk", (d, kv * hd), dt, f"normal:{d ** -0.5}"),
           ("layers.attn.wv", (d, kv * hd), dt, f"normal:{d ** -0.5}"),
           ("layers.attn.wo", (h * hd, d), dt, f"normal:{(h * hd) ** -0.5}")]
    if cfg.get("qk_norm"):
        lay += [("layers.attn.q_norm.scale", (hd,), "float32", "scale"),
                ("layers.attn.k_norm.scale", (hd,), "float32", "scale")]
    f = cfg["intermediate_size"]
    lay += [("layers.norm2.scale", (d,), "float32", "scale"),
            ("layers.mlp.w_gate", (d, f), dt, f"normal:{d ** -0.5}"),
            ("layers.mlp.w_up", (d, f), dt, f"normal:{d ** -0.5}"),
            ("layers.mlp.w_down", (f, d), dt, f"normal:{f ** -0.5}")]
    out += [(name, (n, *shape), dtn, init) for name, shape, dtn, init in lay]
    return out


def _seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{seed}:{name}:{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(spec, seed: int, device, layer: int | None = None) -> torch.Tensor:
    """One leaf (``layer`` None) or one layer's slice of a layered leaf."""
    name, shape, dtn, init = spec
    layered = name.startswith("layers.")
    if layer is None and layered:
        out = torch.empty(shape, dtype=DTYPES[dtn], device=device)
        for i in range(shape[0]):
            out[i] = draw(spec, seed, device, i)
        return out
    shape = shape[1:] if layered else shape
    gen = torch.Generator(device=device).manual_seed(
        _seed(seed, name, layer if layered else -1))
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if init == "scale":
        t = 1.0 + 0.1 * t
    else:
        t = t * float(init.split(":")[1])
    return t.to(DTYPES[dtn])


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf, whole, on ``device``."""
    return {spec[0]: draw(spec, seed, device) for spec in leaf_specs(cfg)}

