"""mamba2-370m [ssm]: SSD, attention-free (arXiv:2405.21060).
48L d_model=1024, ssm_state=128, head_dim 64 (32 SSD heads), d_ff=0."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        segments=uniform("ssm", 48),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )
