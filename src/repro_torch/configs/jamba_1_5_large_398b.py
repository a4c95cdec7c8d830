"""jamba-1.5-large-398b — Mamba+attention hybrid MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2,
1 attention : 7 mamba interleave, MoE every other layer.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536, head_dim=128,
        rope_theta=1e4, activation="silu", glu=True,
        n_experts=16, top_k=2,
        ssm_state=128, ssm_conv=4, ssm_head_dim=64, ssm_expand=2,
        hybrid_period=8, hybrid_attn_index=3, hybrid_moe_every=2,
        microbatches=8,
    )
