"""Train a sparse-MoE block through ``lilac.compile(torch.func.grad_and_value
(...))``.

Transform composition (docs/transforms.md) end to end: a naive one-hot MoE
written in plain torch, a loss, and a plain SGD step, the whole
``grad_and_value`` passed through one ``lilac.compile``:

* the MoE forward in the loss is detected and replaced by a MoE harness
  (E·C work instead of E·T);
* the gradient's own graph goes through the same pass, so the rewrite
  composes with ``torch.func.grad`` instead of being lost to it;
* once selections resolve, the step bakes into an executable plan.

    PYTHONPATH=src python -m repro_torch.examples.train_sparse_moe \\
        [--steps 20] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import lilac
from repro_torch.examples.common import compiled
from repro_torch.models.layers import _moe_naive_2d

T, D, F, E, K = 512, 32, 64, 8, 1
LR = 1e-2


def loss_fn(wg, wu, wd, x, gate, idx, target):
    out = _moe_naive_2d(x, gate, idx, wg, wu, wd)
    return torch.mean((out - target) ** 2)


def train_step(wg, wu, wd, x, gate, idx, target):
    g, loss = torch.func.grad_and_value(loss_fn, argnums=(0, 1, 2))(
        wg, wu, wd, x, gate, idx, target)
    return loss, [w - LR * gw for w, gw in zip((wg, wu, wd), g)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    w = [t(rng.standard_normal((E, D, F)) * .1),
         t(rng.standard_normal((E, D, F)) * .1),
         t(rng.standard_normal((E, F, D)) * .1)]
    x = t(rng.standard_normal((T, D)))
    gate = t(rng.random((T, K)))
    # balanced routing: every expert sees T*K/E tokens, so capacity
    # buckets never drop and the gradients equal the dense oracle's
    idx = torch.from_numpy((np.arange(T * K).reshape(T, K) % E)
                           .astype(np.int32)).to(dev)
    target = t(rng.standard_normal((T, D)))
    data = (x, gate, idx, target)

    fast = lilac.compile(train_step, device=dev)
    _, w_fast = fast(*w, *data)
    # the gradient oracle: the plain step under torch.compile, as the
    # reference jits its step
    _, w_ref = compiled(train_step, dev)(*w, *data)
    err = max(float((a - b).abs().max()) for a, b in zip(w_fast, w_ref))
    print("detection:", fast.last_report.summary())
    print(f"selections: {[n for _, n in fast.last_selections]}")
    print(f"max |w_lilac - w_dense| after one step: {err:.2e}")

    t0 = time.perf_counter()
    for step in range(args.steps):
        loss, w = fast(*w, *data)
        if step % max(1, args.steps // 5) == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {float(loss):.5f}")
    dt = (time.perf_counter() - t0) / args.steps
    info = fast.plan_info()
    print(f"{args.steps} steps at {dt * 1e3:.2f} ms/step; "
          f"baked={info['baked']} plan_hits={info['plan_hits']} "
          f"bake_errors={info['bake_errors']}")


if __name__ == "__main__":
    main()
