"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304; alternating
sLSTM + mLSTM blocks (xLSTM[1:1]) [arXiv:2405.04517].

The blocks carry their own up/down projections (no separate MLP; d_ff=0).
long_500k RUNS: recurrent O(1) decode state per layer.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment, XLSTMSpec

_SPEC = XLSTMSpec(n_heads=4, proj_factor=2.0, conv_width=4)


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        d_model=768,
        vocab_size=50_304,
        segments=(
            Segment(count=6,
                    layers=(LayerSpec(kind="mlstm", mlp="none", xlstm=_SPEC),
                            LayerSpec(kind="slstm", mlp="none", xlstm=_SPEC))),
        ),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        sub_quadratic=True,
    )
