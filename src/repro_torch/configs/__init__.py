"""Architecture configs, one module per model.

Counterpart of ``repro.configs`` for the configs the port runs so far.
"""
from repro_torch.configs.base import ArchConfig  # noqa: F401
