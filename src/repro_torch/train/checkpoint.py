"""Atomic, asynchronous checkpoints that keep the last N.

Counterpart of ``repro.train.checkpoint`` on one device:

  * atomic commit — writes go to ``step_N.tmp/`` and are renamed to
    ``step_N/`` only after every array file and the manifest are fsync'd,
    so a crashed writer leaves nothing that restore could pick up;
  * asynchronous — the tree is copied to host memory at ``save`` (the
    consistency point) and written on a background thread; ``wait()``
    joins it before the next save or a restore;
  * the manifest stores each array's name, shape and dtype; tensors are
    saved as numpy, bf16 as its 16-bit pattern, and ``restore`` puts each
    one on the device and in the dtype of the caller's template tree.

The sharded, resharding restore comes with the distributed slice.
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
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "torch.bfloat16" else t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        """Copy ``tree`` to host memory now, then write it to disk on a
        background thread (or here, with ``blocking``)."""
        self.wait()
        names, vals, _ = _flatten_with_names(tree)
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

    def restore(self, step: int, target_tree):
        """Load into the structure of ``target_tree``: each array on its
        template's device and in its dtype."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {a["name"]: a["dtype"] for a in json.load(f)["arrays"]}
        names, tmpls, spec = _flatten_with_names(target_tree)
        out = []
        for n, tmpl in zip(names, tmpls):
            arr = np.load(os.path.join(d, n.replace("/", "__") + ".npy"))
            t = _from_numpy(arr, dtypes[n])
            out.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
        return pytree.tree_unflatten(out, spec)
