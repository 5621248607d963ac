"""minitron-8b: pruned Nemotron dense GQA transformer [arXiv:2407.14679; hf]
(``repro/configs/minitron_8b.py``)."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=16384,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    attn_chunk=32,
)
