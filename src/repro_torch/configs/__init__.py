"""Architecture configs, one module per ``--arch`` id.

Counterpart of ``repro.configs``: the reference's ten configs (dense,
MoE, RWKV-6, the Jamba hybrid, the HuBERT audio encoder and the InternVL2
language model behind its stub frontend); importing a module registers
its config.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, ShapeConfig, all_archs, get_arch, register,
    shape_skips, smoke_config,
)
# importing each module registers its config
from repro_torch.configs import (  # noqa: F401
    rwkv6_1p6b,
    internvl2_2b,
    granite_moe_3b_a800m,
    olmoe_1b_7b,
    granite_8b,
    mistral_large_123b,
    granite_34b,
    olmo_1b,
    jamba_v0_1_52b,
    hubert_xlarge,
)
