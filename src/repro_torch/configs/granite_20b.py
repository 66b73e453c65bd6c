"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Llama-arch code model. [arXiv:2405.04324]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attn=AttentionConfig(num_heads=48, num_kv_heads=1, head_dim=128, rope_theta=1e4),
    tie_embeddings=False,
)
