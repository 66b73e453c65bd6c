from repro_torch.models.config import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    reduced,
)
from repro_torch.models.layers import DEFAULT_EXEC, TRAIN_EXEC, ExecConfig
from repro_torch.models.backbone import (
    extend_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    serve_step,
)

__all__ = [
    "AttentionConfig", "ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig",
    "reduced", "ExecConfig", "DEFAULT_EXEC", "TRAIN_EXEC", "extend_step", "forward",
    "init_cache", "init_params", "loss_fn", "prefill", "serve_step",
]
