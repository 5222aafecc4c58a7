"""hubert-xlarge — encoder-only audio (w2v2 arch), frame frontend STUB.
[audio] 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504 head_dim=80
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,          # encoder-only: bidirectional attention, no decode
    frontend="stub",       # precomputed frame embeddings via input_specs()
    source="[arXiv:2106.07447; unverified]",
))
