"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent
(arXiv:2402.19427).  38L d_model=4096 16H (MQA kv=1, head_dim 256)
d_ff=12288 vocab=256000, local window 2048, lru_width 4096."""
from repro_torch.models.config import ModelConfig, patterned


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        segments=patterned(("rglru", "rglru", "attn"), 38),
        window=2048,
        lru_width=4096,
        act="gelu_tanh",
        rope_theta=10_000.0,
    )
