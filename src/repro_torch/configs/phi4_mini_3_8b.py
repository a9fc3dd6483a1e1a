"""Phi-4-mini 3.8B. [arXiv:2412.08905]

Dense: RoPE, SwiGLU, GQA kv=8. Full attention -> long_500k via sliding-window
variant.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    ffn="swiglu",
    source="arXiv:2412.08905",
)
