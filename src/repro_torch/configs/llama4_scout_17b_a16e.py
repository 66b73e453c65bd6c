"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + 1 llama4-style shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,  # == expert width; MoE replaces the dense FFN every layer
    vocab_size=202048,
    attn=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128, rope_theta=5e5),
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
    ),
    tie_embeddings=False,
)
