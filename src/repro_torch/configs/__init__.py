from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    ported_archs,
)
