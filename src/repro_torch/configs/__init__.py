"""Architecture configs, one module per ``--arch`` id.

Counterpart of ``repro.configs`` for the configs the port runs so far
(the dense and MoE transformer); importing a module registers its config.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, all_archs, get_arch, register, smoke_config,
)
from repro_torch.configs import olmo_1b, olmoe_1b_7b  # noqa: F401
