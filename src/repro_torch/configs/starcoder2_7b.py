"""starcoder2-7b [dense]: GQA + RoPE, LayerNorm + plain-MLP + biases
(arXiv:2402.19173).  32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

Note: 36 heads is NOT divisible by the 16-way model axis; the sharding layer
falls back to unsharded head dims for this arch and shards attention over
sequence instead (DESIGN.md §6)."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49_152,
        segments=uniform("attn", 32),
        norm="ln",
        act="gelu_tanh",
        mlp_gated=False,
        bias=True,
        rope_theta=1_000_000.0,
    )
