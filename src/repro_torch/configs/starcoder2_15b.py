"""StarCoder2-15B. [arXiv:2402.19173]

Dense code model: GQA kv=4, RoPE, sliding-window attention (4096) per the model
card -> long_500k runs with its native sub-quadratic window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=100_000.0,
    sliding_window=4096,
    ffn="gelu",
    norm="layernorm",
    source="arXiv:2402.19173",
)
