"""chatglm3-6b [dense]: 2d-RoPE (half-dim rotary), GQA (arXiv:2406.12793).
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65_024,
        segments=uniform("attn", 28),
        rotary_frac=0.5,
    )
