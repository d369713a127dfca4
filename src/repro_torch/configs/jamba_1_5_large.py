"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536; MoE 16e top-2; Mamba:attention 7:1 interleave
[arXiv:2403.19887].

72 layers = 9 x (one block of 8: layers 0-6 Mamba, layer 7 attention); MoE
replaces the dense MLP on every other layer (odd positions in the block).
long_500k RUNS: Mamba state is O(1) per layer and only the 9 attention
layers keep an O(S) KV cache.
"""
from repro_torch.configs.base import (AttnSpec, LayerSpec, MambaSpec, MoESpec,
                                ModelConfig, Segment)

_ATTN = AttnSpec(n_heads=64, n_kv_heads=8, head_dim=128,
                 rope_theta=10_000.0, use_rope=False)  # Jamba: no positional enc
_MAMBA = MambaSpec(d_state=16, d_conv=4, expand=2)
_MOE = MoESpec(n_experts=16, top_k=2, d_ff_expert=24_576)


def _block() -> tuple[LayerSpec, ...]:
    layers = []
    for i in range(8):
        kind = "attn" if i == 7 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        layers.append(LayerSpec(
            kind=kind,
            mlp=mlp,
            attn=_ATTN if kind == "attn" else None,
            mamba=_MAMBA if kind == "mamba" else None,
            moe=_MOE if mlp == "moe" else None,
            d_ff=24_576 if mlp == "dense" else 0,
        ))
    return tuple(layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=8192,
        vocab_size=65_536,
        segments=(Segment(count=9, layers=_block()),),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=True,    # Mamba O(1) state; attn cache on 9 layers only
        moe_seq_chunk=1024,
    )
