"""The paper's own serving trio (§7.1): Llama 7B target + 1B / 300M drafts.

These drive the GreenLLM reproduction benchmarks (Figs. 2-15): the 7B is
the Standalone/target model on the "new" chip, the 1B/300M are the
speculative-decoding draft models placed on "old" chips.
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

LLAMA_7B = ModelConfig(
    name="llama-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=128, rope_theta=1e4),
    tie_embeddings=False,
)

LLAMA_1B = ModelConfig(
    name="llama-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    d_ff=5504,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128, rope_theta=1e4),
    tie_embeddings=False,
)

LLAMA_300M = ModelConfig(
    name="llama-300m",
    family="dense",
    num_layers=12,
    d_model=1024,
    d_ff=2816,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64, rope_theta=1e4),
    tie_embeddings=True,
)

CONFIG = LLAMA_7B
