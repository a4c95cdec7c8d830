"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000, head_dim=64,
        rope_theta=1e4, activation="silu", glu=True,
    )
