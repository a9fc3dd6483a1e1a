"""Mamba2-2.7B. [arXiv:2405.21060]

Attention-free SSM with SSD (state-space duality): chunked dual form for training,
O(1) recurrent state for decode -> long_500k native. d_ff=0 (the Mamba block is
the whole layer).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ffn="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256, conv_width=4, ngroups=1),
    source="arXiv:2405.21060",
)
