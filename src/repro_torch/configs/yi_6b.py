"""yi-6b [dense]: llama-arch GQA (arXiv:2403.04652).
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64_000,
        segments=uniform("attn", 32),
        rope_theta=5_000_000.0,
    )
