"""Llama-4 Scout 17B-active / 16 experts. [hf:meta-llama/Llama-4-Scout-17B-16E]

MoE with 16 routed experts, top-1 routing plus one shared expert, early-fusion
multimodal (vision frontend stubbed per brief), GQA kv=8, iRoPE-style chunked-local
attention on 3 of every 4 layers which makes long_500k sub-quadratic.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig  # noqa: F401

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    rope_theta=500_000.0,
    use_qk_norm=True,
    chunk_attn_window=8192,
    global_attn_every=4,
    ffn="swiglu",
    moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1, expert_d_ff=8192, every=1),
    frontend_embed_dim=1408,  # ViT patch embeddings stub (early fusion)
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
