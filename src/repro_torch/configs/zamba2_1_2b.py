"""zamba2-1.2b: a Mamba2 backbone and ONE weight-shared attention + SwiGLU block
applied after every 6th mamba layer [arXiv:2411.15242; hf]
(``repro/configs/zamba2_1_2b.py``). d_inner = 2*2048 = 4096, head_dim 64 ->
64 SSD heads, state N=64; 38 layers -> 6 applications of the shared block."""

from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=64),
    ssm=SSMConfig(state_dim=64, head_dim=64, num_groups=1),
    attn_period=6,
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    ssm=SSMConfig(state_dim=16, head_dim=16, num_groups=1, chunk=16),
    attn_period=2,
    attn_chunk=32,
)
