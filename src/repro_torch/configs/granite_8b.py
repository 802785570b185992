"""granite-8b [dense]: llama-arch, code (arXiv:2405.04324).
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49_152,
        segments=uniform("attn", 36),
        rope_theta=10_000_000.0,
    )
