"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    d_ff=1408,
    vocab_size=151936,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128, rope_theta=1e6),
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared_experts=4,
        d_ff_shared=5632,  # 4 x 1408 fused
    ),
    tie_embeddings=False,
)
