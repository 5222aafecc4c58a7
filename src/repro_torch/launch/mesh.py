"""Process groups and device meshes.

Counterpart of ``repro.launch.mesh``.  The meshes are built by functions
(not module constants), so importing this module touches no device or
process-group state.

``init_distributed`` is the port's one place that starts
``torch.distributed``: it reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` as ``torchrun`` sets them and takes the backend as an
argument, ``"nccl"`` or ``"gloo"``.  A mesh over gloo is a CPU mesh: a
collective of ``launch.collectives`` copies a CUDA operand to the host
and back (several ranks on one card, or CPU-only tests); over NCCL the
mesh is a CUDA mesh and nothing is staged.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# the persistent stores a rank keeps to itself: (environment variable,
# file name under the cache directory)
_STORES = (("LILAC_TORCH_AUTOTUNE_CACHE", "autotune.json"),
           ("LILAC_TORCH_PLAN_CACHE", "plans.json"),
           ("LILAC_TORCH_QUARANTINE_CACHE", "quarantine.json"))


def init_distributed(backend: str, device: Optional[str] = None) -> int:
    """Start the default process group from torchrun's environment (a
    no-op if it is up) and return this rank.  ``device="cuda"`` binds the
    rank to card ``LOCAL_RANK`` modulo the cards there are (several ranks
    share one card when there are fewer cards than ranks).  Each rank's
    autotune, plan and quarantine stores become files of its own
    (``<name>.rank<r>.json`` beside the store it would use), since a
    store rewrites its whole file and ranks sharing one would lose each
    other's records."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, and CUDA is not "
                               "available on this rank")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if dist.get_world_size() > 1:
        from repro_torch.core.jsonstore import cache_dir

        for var, name in _STORES:
            path = Path(os.environ.get(var) or cache_dir() / name)
            if ".rank" not in path.stem:
                os.environ[var] = str(path.with_name(
                    f"{path.stem}.rank{rank}{path.suffix}"))
    return rank


def _mesh(shape, names):
    """A mesh over the default process group: on CUDA over NCCL, on the
    CPU over any other backend (gloo, or the dry-run's fake one)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod.  Needs a
    process group of that size (the dry-run's is a fake one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the default process group's ranks
    (data x model of them)."""
    return _mesh((data, model), ("data", "model"))


def mesh_rules(multi_pod: bool = False):
    from repro_torch.models.spec import MULTI_POD_RULES, SINGLE_POD_RULES
    return MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES
