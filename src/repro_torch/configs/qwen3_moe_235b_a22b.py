"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3 family; hf].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
MoE 128e top-8.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab=151936, head_dim=128,
        rope_theta=1e6, qk_norm=True, activation="silu", glu=True,
        n_experts=128, top_k=8,
        microbatches=4,
    )
