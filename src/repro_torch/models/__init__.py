"""Models of the port: the shared layers, the dense and MoE transformer
and the factory (counterpart of ``repro.models``)."""
from repro_torch.models.factory import Model, build_model  # noqa: F401
