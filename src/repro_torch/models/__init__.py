from repro_torch.models.config import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    reduced,
)
from repro_torch.models.layers import DEFAULT_EXEC, ExecConfig
from repro_torch.models.backbone import (
    extend_step,
    init_cache,
    init_params,
    prefill,
    serve_step,
)

__all__ = [
    "AttentionConfig", "ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig",
    "reduced", "ExecConfig", "DEFAULT_EXEC", "extend_step", "init_cache", "init_params",
    "prefill", "serve_step",
]
