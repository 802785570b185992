"""whisper-medium [audio]: encoder-decoder (arXiv:2212.04356).  Backbone
only — the conv/mel frontend is a STUB providing precomputed frame
embeddings (1500 frames).  24L enc + 24L dec, d_model=1024 16H (MHA kv=16,
head_dim 64) d_ff=4096 vocab=51865 (PADDED to 51872 = 16*3242 so the (B,S,V) f32 loss
blocks shard on the model axis; 7 dead ids, standard production practice).
LayerNorm, plain MLP, biases,
sinusoidal absolute positions (learned-positions deviation noted; published
decoder caps at 448 tokens — decode cells are exercised structurally)."""
from repro_torch.models.config import ModelConfig, uniform


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_872,  # padded from 51865 to divide the 16-way model axis
        segments=uniform("xattn", 24),
        encoder_segments=uniform("attn", 24),
        encoder_seq=1500,
        norm="ln",
        act="gelu",
        mlp_gated=False,
        bias=True,
        rotary_frac=0.0,
        abs_positions=True,
        frontend="audio",
        tie_embeddings=True,
    )
