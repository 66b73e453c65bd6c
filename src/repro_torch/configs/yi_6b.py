"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-arch GQA. [arXiv:2403.04652]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128, rope_theta=5e6),
    tie_embeddings=False,
)
