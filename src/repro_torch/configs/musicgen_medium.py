"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048. Decoder-only over EnCodec tokens; the EnCodec frontend is a
stub - input_specs() feeds precomputed frame embeddings. [arXiv:2306.05284]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    attn=AttentionConfig(num_heads=24, num_kv_heads=24, head_dim=64, rope_theta=1e4),
    frontend="audio_frames",
    tie_embeddings=True,
)
