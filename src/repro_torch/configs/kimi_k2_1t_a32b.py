"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared expert, DeepSeek-style).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=112,
        rope_theta=5e4, activation="silu", glu=True,
        n_experts=384, top_k=8, n_shared_experts=1,
        microbatches=8,
    )
