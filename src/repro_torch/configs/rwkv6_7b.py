"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
RWKV6 "Finch" - data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, lora_dim_decay=64, lora_dim_mix=32),
    tie_embeddings=False,
)
