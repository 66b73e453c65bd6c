"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Llama-arch GQA. [arXiv:2403.04652]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64000,
    attn=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128, rope_theta=5e6),
    tie_embeddings=False,
)
