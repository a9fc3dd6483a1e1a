"""Qwen1.5-MoE-A2.7B. [hf:Qwen/Qwen1.5-MoE-A2.7B]

Fine-grained MoE: 60 routed experts top-4 plus 4 shared experts, expert d_ff 1408,
GQA kv=16 (no grouping), RoPE, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,  # shared-expert path width (4 x 1408)
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    ffn="swiglu",
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4, expert_d_ff=1408, every=1),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
