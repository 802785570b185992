"""olmoe-1b-7b [moe]: 64 experts top-8 (arXiv:2409.02060).
16L d_model=2048 16H (MHA kv=16) expert d_ff=1024 vocab=50304."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50_304,
        segments=uniform("moe", 16),
        num_experts=64,
        top_k=8,
        expert_d_ff=1024,
    )
