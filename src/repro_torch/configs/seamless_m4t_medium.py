"""SeamlessM4T-medium. [arXiv:2308.11596]

Encoder-decoder multimodal translation backbone. The speech frontend
(mel-spectrogram + conformer feature extractor) is stubbed: input_specs provides
precomputed frame embeddings (frontend_embed_dim) that a learned projector maps
to d_model. 12 encoder + 12 decoder layers, post-LN transformer, GELU FFN,
no GQA grouping (kv=16).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    ffn="gelu",
    norm="layernorm",
    tie_embeddings=True,
    frontend_embed_dim=160,  # 80-dim mel x2 frame stacking stub
    source="arXiv:2308.11596",
)
