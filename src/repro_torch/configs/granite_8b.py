"""IBM Granite Code 8B. [arXiv:2405.04324]

Llama-architecture dense code model: GQA kv=8, RoPE, SwiGLU.
Full attention -> long_500k runs only as an explicit sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    rope_theta=10_000_000.0,
    ffn="swiglu",
    source="arXiv:2405.04324",
)
