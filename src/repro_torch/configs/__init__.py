from repro_torch.configs.base import (  # noqa: F401
    FULL_ATTENTION,
    LayerSpec,
    ModelConfig,
    get_config,
    list_configs,
    register,
)
