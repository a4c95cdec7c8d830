"""qwen2-vl-72b — VLM backbone, M-RoPE [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Vision frontend is a stub: the model takes precomputed patch embeddings
and 3D M-RoPE positions.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        rope_theta=1e6, use_mrope=True, activation="silu", glu=True,
        microbatches=4,
    )
