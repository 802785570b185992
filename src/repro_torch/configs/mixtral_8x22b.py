"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention
(arXiv:2401.04088).  56L d_model=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768, SWA window 4096."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32_768,
        segments=uniform("moe", 56),
        num_experts=8,
        top_k=2,
        expert_d_ff=16384,
        window=4096,
        train_microbatches=4,
        prefill_row_chunks=2,
    )
