"""Model configurations (the port's copy of ``repro.configs``)."""
from repro_torch.configs.base import AttnKind, Family, ModelConfig, reduced  # noqa: F401
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: F401
