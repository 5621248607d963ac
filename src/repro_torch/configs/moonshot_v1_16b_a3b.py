"""moonshot-v1-16b-a3b (Moonlight): 64-expert top-6 fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B; hf] (``repro/configs/moonshot_v1_16b_a3b.py``).
Uniform MoE layers: the real model's dense first layer is omitted, as in the
JAX package."""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=1408,
    vocab_size=163840,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6),
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=96,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=3, group_size=64),
    attn_chunk=32,
)
