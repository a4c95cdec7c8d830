"""starcoder2-15b — dense GQA code LM [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 — GQA, RoPE.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab=49152, head_dim=128,
        rope_theta=1e5, activation="gelu", glu=False,
    )
