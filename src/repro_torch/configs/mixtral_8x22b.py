"""mixtral-8x22b: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf] (``repro/configs/mixtral_8x22b.py``). The window of
4,096 keys makes the decode cache rolling: it holds the last 4,096 keys."""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    attn=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128, window=4096),
    moe=MoEConfig(num_experts=8, top_k=2),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16, window=16),
    moe=MoEConfig(num_experts=4, top_k=2, group_size=64),
    attn_chunk=32,
)
