"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local(sliding-window 512):global attention pattern, 128k context
[hf:google/gemma-3-1b-pt]. 26 layers = 4 x (5 local + 1 global) + 2 local.
long_500k RUNS: 24/26 layers keep a bounded (512) ring cache; the 4-ish
global layers decode O(S)/token with GQA kv=1 (cache ~0.5 GB/layer at 500k).
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_LOCAL = AttnSpec(n_heads=4, n_kv_heads=1, head_dim=256, qk_norm=True,
                  rope_theta=10_000.0, window=512)
_GLOBAL = AttnSpec(n_heads=4, n_kv_heads=1, head_dim=256, qk_norm=True,
                   rope_theta=1_000_000.0, window=None)


def _layer(attn: AttnSpec) -> LayerSpec:
    return LayerSpec(kind="attn", mlp="dense", attn=attn, d_ff=6912)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        d_model=1152,
        vocab_size=262_144,
        segments=(
            Segment(count=4, layers=tuple([_layer(_LOCAL)] * 5
                                          + [_layer(_GLOBAL)])),
            Segment(count=1, layers=tuple([_layer(_LOCAL)] * 2)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        sub_quadratic=True,   # sliding-window local layers bound the cache
        ce_chunk=512,         # 262k vocab: never materialize full logits
    )
