"""internvl2-76b [vlm]: InternViT + LLM backbone (arXiv:2404.16821).
Backbone only per assignment — the vision frontend is a STUB providing
precomputed patch embeddings (256 patches).  80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128_256,
        segments=uniform("attn", 80),
        frontend="vision",
        num_patches=256,
        train_microbatches=2,
        rope_theta=500_000.0,
    )
