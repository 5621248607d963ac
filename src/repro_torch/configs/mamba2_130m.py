"""mamba2-130m: attention-free SSD (state-space duality) [arXiv:2405.21060]
(``repro/configs/mamba2_130m.py``). d_inner = 2*768 = 1536, head_dim 64 ->
24 SSD heads, state N=128."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, num_groups=1),
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, num_groups=1, chunk=16),
)
