"""seamless-m4t-large-v2 — enc-dec multimodal [arXiv:2308.11596; hf].

24L encoder + 24L decoder, d_model=1024 16H (MHA kv=16) d_ff=8192
vocab=256206.  Modality frontend is a stub: ``serve_loop`` feeds
precomputed frame embeddings (B, T, d_model) to the encoder.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, n_encoder_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, head_dim=64,
        rope_theta=1e4, activation="gelu", glu=False,
    )
