"""nemotron-4-15b — dense GQA, squared-ReLU [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128,
        rope_theta=1e4, activation="squared_relu", glu=False,
    )
