from .base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MoECfg,
    ShapeCfg,
    SSMCfg,
    get_config,
    list_configs,
    smoke_variant,
)
