"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. M-RoPE (16/24/24 sections over the 64 rotary freqs), dynamic
resolution. The vision tower is a stub - input_specs() feeds precomputed
patch embeddings + 3-stream position ids. [arXiv:2409.12191]"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    attn=AttentionConfig(
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        m_rope_sections=(16, 24, 24),
    ),
    frontend="vision_patches",
    tie_embeddings=False,
)
