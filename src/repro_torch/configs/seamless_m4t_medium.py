"""seamless-m4t-medium: an encoder-decoder multimodal transformer
[arXiv:2308.11596; hf] (``repro/configs/seamless_m4t_medium.py``). "12L" as
12 encoder and 12 decoder layers; vocab 256,206 pads to 256,256. The audio
frontend is a stub: a prefill takes precomputed 80-d fbank frames, projected
to d_model by one learned matrix."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64),
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    attn_chunk=32,
)
