"""phi-3-vision-4.2b: the phi3-mini backbone with a CLIP patch frontend (a
stub) [hf:microsoft/Phi-3-vision-128k-instruct; hf]
(``repro/configs/phi_3_vision_4_2b.py``). A prefill takes 256 precomputed
patch embeddings, prepended to the text sequence."""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96),
    num_patches=256,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    num_patches=8,
    attn_chunk=32,
)
