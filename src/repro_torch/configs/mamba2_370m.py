"""mamba2-370m — SSD state-space model [arXiv:2405.21060; unverified].

48L d_model=1024 (attention-free), ssm_state=128, vocab=50280.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280, head_dim=64,
        ssm_state=128, ssm_conv=4, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True,
    )
