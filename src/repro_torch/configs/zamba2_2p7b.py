"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 blocks + a shared-weight attention block applied every
6 layers (9 taps). [arXiv:2411.15242]"""
from repro_torch.models.config import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=80, rope_theta=1e4),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk_size=128),
    hybrid_attn_every=6,
    tie_embeddings=True,
)
