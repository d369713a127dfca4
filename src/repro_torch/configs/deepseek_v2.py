"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff_expert=1536
vocab=102400; MLA kv_lora=512, 2 shared + 160 routed experts top-6
[arXiv:2405.04434].

Layer 0 keeps a dense MLP (d_ff=12288) per the paper; layers 1-59 are MoE.
long_500k SKIPPED: full attention — MLA compresses the cache (576/token)
but does not bound it (DESIGN.md SS4).
"""
from repro_torch.configs.base import (LayerSpec, MLASpec, MoESpec, ModelConfig,
                                Segment)

_MLA = MLASpec(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
               qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
               rope_theta=10_000.0)
_MOE = MoESpec(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        d_model=5120,
        vocab_size=102_400,
        segments=(
            Segment(count=1,
                    layers=(LayerSpec(kind="mla", mlp="dense", mla=_MLA,
                                      d_ff=12_288),)),
            Segment(count=59,
                    layers=(LayerSpec(kind="mla", mlp="moe", mla=_MLA,
                                      moe=_MOE),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=False,
        moe_seq_chunk=1024,
        mla_absorb=False,       # paper-faithful default; SSPerf flips this
    )
