"""qwen3-14b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 — qk_norm, GQA.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        rope_theta=1e6, qk_norm=True, activation="silu", glu=True,
        pad_heads_to=48,   # 40 heads do not divide the 16-way model axis;
        # lowered with 8 zero-masked heads (output-exact)
    )
