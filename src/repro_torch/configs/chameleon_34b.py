"""Chameleon-34B. [arXiv:2405.09818]

Early-fusion mixed-modal decoder: VQ image tokens share the 65536 text vocab, so
the backbone is a plain decoder LM consuming interleaved token ids (the VQ-GAN
tokenizer is the stubbed frontend). Uses QK-norm per the paper. Full attention ->
long_500k via sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    use_qk_norm=True,
    ffn="swiglu",
    norm="layernorm",
    source="arXiv:2405.09818",
)
