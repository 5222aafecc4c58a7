"""RWKV-6 in bf16 against f32, layer by layer, in the port and in the JAX
package on the same parameters and tokens.

Two readings per layer, both on the forward over the whole sequence:

* the residual stream's relative L2 between the bf16 model and its f32
  copy (the f32 forward is the oracle), in the port and in the reference.
  Both grow with depth at the same rate: each layer's bf16 rounding is
  carried into every layer above it, so the spread at the top of a deep
  stack is the architecture's, not the port's;
* the port's decode held against its own forward, one layer at a time on
  that layer's own inputs (``chip_smoke.rwkv_layers``): the rounding of
  one layer, free of the layers below.  ``chip_smoke.py`` bounds it by
  ``RWKV_BF16_LAYER_RTOL``, which an extra bf16 rounding of the
  recurrent state in the decode path exceeds (the last test).

The tests run at d_model 256 and 4 layers.  Run the file to read both at
the published width (d_model 2,048, 32 heads, d_ff 7,168, vocab 65,536)
and a reduced depth, on the CPU:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_rwkv_bf16.py \\
        --layers 4 --prompt 256 --steps 8
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.spec import tree_map

SMALL = dict(n_layers=4, d_model=256, n_heads=4, d_ff=896)


def _np(t):
    return t.float().numpy()


def reference_layers(jcfg, params, tokens):
    """The reference's residual stream after each layer (embedding
    first), through its own ``apply_block``; ``params`` a tree of jnp
    arrays, its dtypes the model's."""
    x = params["embed"][jnp.asarray(tokens)]
    xs = [np.asarray(x.astype(jnp.float32))]
    (mixer, ffn), = JT.arch_pattern(jcfg)
    for j in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a: a[j], params["blocks"])["b0"]
        x, _, _ = JT.apply_block(jcfg, bp, x, mixer=mixer, ffn=ffn,
                                 positions=None)
        xs.append(np.asarray(x.astype(jnp.float32)))
    return xs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def readings(over, prompt: int, steps: int, seed: int = 23):
    """Per layer, for the port and the reference on the port's bf16
    parameters (drawn from ``seed``) and their f32 copy: the residual
    stream's bf16-to-f32 relative L2; the two packages' bf16 streams
    against each other; the port's decode against its forward, per layer
    (``chip_smoke.rwkv_layers``), in bf16 and in f32."""
    cfg = get_arch("rwkv6-1.6b").replace(**over)
    jcfg = jget_arch("rwkv6-1.6b").replace(**over)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   "cpu")
    p32 = tree_map(lambda a: a.float(), params)
    cfg32 = cfg.replace(param_dtype=torch.float32, cache_dtype=torch.float32)
    tokens = torch.randint(1, cfg.vocab, (2, prompt + steps),
                           generator=torch.Generator().manual_seed(seed + 6),
                           dtype=torch.int32)
    with torch.no_grad():
        tb, db = C.rwkv_layers(cfg, params, tokens, prompt, steps)
        tf, df = C.rwkv_layers(cfg32, p32, tokens, prompt, steps)
    tb, tf = [_np(x) for x in tb], [_np(x) for x in tf]
    # the same numbers as the reference's, each leaf at the port's dtype
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jb = tree_map(lambda a: jnp.asarray(_np(a), jdt[a.dtype]), params)
    jf = tree_map(lambda a: jnp.asarray(_np(a)), params)
    rb = reference_layers(jcfg, jb, tokens.numpy())
    rf = reference_layers(jcfg, jf, tokens.numpy())
    return {
        "port_bf16_to_f32": [_rel(b, f) for b, f in zip(tb[1:], tf[1:])],
        "ref_bf16_to_f32": [_rel(b, f) for b, f in zip(rb[1:], rf[1:])],
        "port_to_ref_bf16": [_rel(t, r) for t, r in zip(tb[1:], rb[1:])],
        "port_to_ref_f32": [_rel(t, r) for t, r in zip(tf[1:], rf[1:])],
        "decode_bf16": db, "decode_f32": df}


@pytest.fixture(scope="module")
def small():
    return readings(SMALL, prompt=48, steps=6)


def test_both_packages_spread_alike_with_depth(small):
    """The bf16 model leaves its f32 copy further behind at every layer,
    in both packages, and the port's spread is the reference's within a
    factor 1.5 at each layer; in f32 the two packages agree to 1e-5."""
    p, r = small["port_bf16_to_f32"], small["ref_bf16_to_f32"]
    assert all(b > a for a, b in zip(p, p[1:])), p
    assert all(b > a for a, b in zip(r, r[1:])), r
    for a, b in zip(p, r):
        assert 1 / 1.5 <= a / b <= 1.5, (p, r)
    assert max(small["port_to_ref_f32"]) <= 1e-5, small["port_to_ref_f32"]


def test_each_layer_decodes_as_its_forward(small):
    """One layer at a time on its own inputs: the bf16 decode within
    ``RWKV_BF16_LAYER_RTOL`` of the forward, the f32 within 1e-5."""
    assert max(small["decode_bf16"]) <= C.RWKV_BF16_LAYER_RTOL, small
    assert max(small["decode_f32"]) <= 1e-5, small


def test_a_bf16_state_in_the_decode_exceeds_the_layer_bound(monkeypatch):
    """The per-layer bound catches a fault the f32 run cannot show: the
    recurrent state rounded to bf16 between decode steps."""
    decode_block = T.decode_block

    def rounded(cfg, bp, x, ce, pos, **kw):
        y, ce = decode_block(cfg, bp, x, ce, pos, **kw)
        return y, dict(ce, s=ce["s"].to(x.dtype).float())

    monkeypatch.setattr(T, "decode_block", rounded)
    cfg = get_arch("rwkv6-1.6b").replace(**SMALL)
    params = build_model(cfg).init(torch.Generator().manual_seed(23), "cpu")
    tokens = torch.randint(1, cfg.vocab, (2, 80),
                           generator=torch.Generator().manual_seed(29),
                           dtype=torch.int32)
    with torch.no_grad():
        _, dist = C.rwkv_layers(cfg, params, tokens, 48, 32)
    assert max(dist) > C.RWKV_BF16_LAYER_RTOL, dist


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="the tests' width instead of the published one")
    a = ap.parse_args()
    over = dict(SMALL) if a.small else {}
    over["n_layers"] = a.layers
    res = readings(over, a.prompt, a.steps)
    for k, v in res.items():
        print(f"{k:18s}", " ".join(f"{x:.3g}" for x in v))


if __name__ == "__main__":
    main()
