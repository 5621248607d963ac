from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    get_config,
    get_shape,
    ported_archs,
)
