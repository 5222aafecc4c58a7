"""Atomic, asynchronous checkpoints that keep the last N, saved from a
mesh and restored onto another.

Counterpart of ``repro.train.checkpoint``:

  * atomic commit — writes go to ``step_N.tmp/`` and are renamed to
    ``step_N/`` only after every array file and the manifest are fsync'd,
    so a crashed writer leaves nothing that restore could pick up;
  * asynchronous — the tree is copied to host memory at ``save`` (the
    consistency point) and written on a background thread; ``wait()``
    joins it before the next save or a restore;
  * the manifest stores each array's name, shape and dtype; tensors are
    saved as numpy, bf16 as its 16-bit records (the reference's ``V2``
    arrays, which its restore reads back as bf16), and ``restore`` puts each
    one on the device and in the dtype of the caller's template tree;
  * sharded (``shardings=``, a tree of ``models.spec.NamedSharding``):
    ``save`` gathers each leaf from the ranks' shards
    (``DTensor.full_tensor()``), rank 0 writes the global arrays in the
    one-device format (one ``.npy`` a leaf and ``manifest.json``, the
    reference's files) and every rank waits at a barrier until the
    rename is done; ``restore`` places each global array by the TARGET
    placements (``distribute_tensor(..., src_data_rank=None)``: each
    rank slices its own block, no scatter), so a checkpoint saved on a
    (4, 2) mesh restores onto (2, 4) or onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _flatten_with_names(tree):
    flat, spec = pytree.tree_flatten_with_path(tree)
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat]
    return names, [v for _, v in flat], spec


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 as the reference writes it: its 16-bit records, a void ``V2``
    array (what ``np.save`` makes of an ml_dtypes bfloat16 array)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":          # 16-bit records (older files: int16)
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "torch.bfloat16" else t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False,
             shardings=None):
        """Copy ``tree`` to host memory now, then write it to disk on a
        background thread (or here, with ``blocking``).  With
        ``shardings`` the leaves are the rank's shards: each is gathered,
        rank 0 writes, and the call returns on every rank after the
        commit."""
        self.wait()
        names, vals, _ = _flatten_with_names(tree)
        if shardings is not None:
            vals = [_gather(v, sh) for v, sh in
                    zip(vals, _flatten_shardings(shardings, tree))]
            if torch.distributed.get_rank() != 0:
                torch.distributed.barrier()
                return
            blocking = True
        host = [_to_numpy(v) for v in vals]     # device -> host copy now
        meta = {"step": step,
                "arrays": [{"name": n, "shape": list(v.shape),
                            "dtype": str(v.dtype)}
                           for n, v in zip(names, vals)]}

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for n, v in zip(names, host):
                with open(os.path.join(tmp, n.replace("/", "__") + ".npy"),
                          "wb") as f:
                    np.save(f, v)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)               # atomic commit
            self._gc()

        if blocking:
            write()
            if shardings is not None:
                torch.distributed.barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.available_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def available_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, d,
                                                    "manifest.json")):
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Load into the structure of ``target_tree``: each array on its
        template's device and in its dtype; with ``shardings`` each one is
        this rank's block at the target placements (the elastic-restart
        path), which must have the template's shape."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {a["name"]: a["dtype"] for a in json.load(f)["arrays"]}
        names, tmpls, spec = _flatten_with_names(target_tree)
        shards = (_flatten_shardings(shardings, target_tree)
                  if shardings is not None else [None] * len(names))
        out = []
        for n, tmpl, sh in zip(names, tmpls, shards):
            arr = np.load(os.path.join(d, n.replace("/", "__") + ".npy"))
            t = _from_numpy(arr, dtypes[n])
            if sh is not None:
                t = _local_block(t, sh)
                if tuple(t.shape) != tuple(tmpl.shape):
                    raise ValueError(f"{n}: the block at {sh.spec} is "
                                     f"{tuple(t.shape)}, the template "
                                     f"{tuple(tmpl.shape)}")
            out.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
        return pytree.tree_unflatten(out, spec)


def _flatten_shardings(shardings, like) -> list:
    """The sharding tree's leaves in ``like``'s leaf order."""
    return pytree.tree_structure(like).flatten_up_to(shardings)


def _gather(local: torch.Tensor, sh) -> torch.Tensor:
    """The global tensor of a rank's block at ``sh``."""
    from torch.distributed.tensor import DTensor
    dt = DTensor.from_local(local.to(sh.mesh.device_type), sh.mesh,
                            sh.placements, run_check=False)
    return dt.full_tensor()


def _local_block(full: torch.Tensor, sh) -> torch.Tensor:
    """This rank's block of a global tensor at ``sh``, sliced locally."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(sh.mesh.device_type), sh.mesh,
                             sh.placements, src_data_rank=None).to_local()
