"""qwen2.5-3b: dense GQA transformer with QKV bias [hf:Qwen/Qwen2.5; hf]
(``repro/configs/qwen2_5_3b.py``)."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    attn=AttentionConfig(num_heads=16, num_kv_heads=2, head_dim=128, qkv_bias=True),
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True),
    attn_chunk=32,
)
