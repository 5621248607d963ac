"""merinda-gru: the paper's own model family as an LM config: GRU neural-flow
sequence mixers (core/neural_flow.py; kernels/gru_scan on the card) and
SwiGLU MLPs (``repro/configs/merinda_gru.py``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="merinda-gru",
    family="gru",
    num_layers=8,
    d_model=512,
    d_ff=1536,
    vocab_size=32000,
    gru_hidden=512,
)

SMOKE = ModelConfig(
    name="merinda-gru-smoke",
    family="gru",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    gru_hidden=64,
)
