"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE, GQA. [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151552,
    attn=AttentionConfig(num_heads=32, num_kv_heads=2, head_dim=128, rope_theta=1e6),
    tie_embeddings=False,
)
