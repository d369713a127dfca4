"""whisper-small [audio] — enc-dec, 12L encoder + 12L decoder, d_model=768
12H (MHA) d_ff=3072 vocab=51865 [arXiv:2212.04356].

The conv/mel frontend is a STUB: input_specs provides precomputed frame
embeddings (B, 1500, 768). Positional adaptation (DESIGN.md SS4): RoPE
replaces whisper's sinusoidal/learned absolute positions so the assigned
decode shapes (32k >> whisper's 448) stay well-defined without resizing a
learned table.
long_500k SKIPPED: full attention.
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_SELF = AttnSpec(n_heads=12, n_kv_heads=12, head_dim=64,
                 rope_theta=10_000.0)
_ENC = AttnSpec(n_heads=12, n_kv_heads=12, head_dim=64,
                rope_theta=10_000.0, causal=False)

N_FRAMES = 1500   # 30 s of audio at the frontend's 50 Hz output


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        d_model=768,
        # true vocab 51,865 — padded to a 256-multiple for TP vocab
        # sharding (see internvl2_1b.py note)
        vocab_size=51_968,
        segments=(
            Segment(count=12,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_SELF,
                                      d_ff=3072),)),
        ),
        encoder_segments=(
            Segment(count=12,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_ENC,
                                      d_ff=3072),)),
        ),
        encoder_max_len=N_FRAMES,
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        sub_quadratic=False,
    )
