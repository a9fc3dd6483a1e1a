"""RecurrentGemma-9B (Griffin). [arXiv:2402.19427]

Hybrid: RG-LRU recurrent blocks with local sliding-window attention in a
(recurrent, recurrent, local-attn) repeating pattern — "1:2". GQA with a single
KV head (MQA) in the attention blocks. Attention-light -> long_500k native.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    ffn="geglu",
    rglru=RGLRUConfig(lru_width=0, conv_width=4, pattern_period=3,
                      attn_positions=(2,), local_window=2048),
    source="arXiv:2402.19427",
)
