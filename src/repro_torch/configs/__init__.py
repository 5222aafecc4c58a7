"""Architecture configs, one module per ``--arch`` id.

Counterpart of ``repro.configs`` for the configs the port runs so far:
the dense and MoE transformers and RWKV-6; importing a module registers
its config.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, all_archs, get_arch, register, smoke_config,
)
# importing each module registers its config
from repro_torch.configs import (  # noqa: F401
    rwkv6_1p6b,
    granite_moe_3b_a800m,
    olmoe_1b_7b,
    granite_8b,
    mistral_large_123b,
    granite_34b,
    olmo_1b,
)
