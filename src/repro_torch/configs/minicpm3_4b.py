"""MiniCPM3-4B. [hf:openbmb/MiniCPM3-4B]

Dense with Multi-head Latent Attention (MLA): low-rank KV compression; all 40
heads share the compressed latent (config lists kv=40 i.e. no GQA grouping at the
head level — MLA compresses along the feature dim instead).
Full attention -> long_500k via sliding-window variant.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    head_dim=96,  # qk_nope(64) + qk_rope(32)
    ffn="swiglu",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)
