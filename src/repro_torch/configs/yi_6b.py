"""yi-6b: llama-architecture dense GQA transformer [arXiv:2403.04652; hf]
(``repro/configs/yi_6b.py``)."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128),
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    attn_chunk=32,
)
