from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig,
    ModelConfig,
    SSMConfig,
    get_config,
    ported_archs,
)
