"""internlm2-20b: dense GQA transformer [arXiv:2403.17297; hf]
(``repro/configs/internlm2_20b.py``)."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab_size=92544,
    attn=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128),
)

SMOKE = ModelConfig(
    name="internlm2-20b-smoke",
    family="dense",
    num_layers=2,
    d_model=96,
    d_ff=192,
    vocab_size=512,
    attn=AttentionConfig(num_heads=6, num_kv_heads=2, head_dim=16),
    attn_chunk=32,
)
