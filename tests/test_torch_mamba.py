"""The Mamba block and Jamba (the hybrid family) against the JAX package.

* ``mamba_block`` over a sequence (past the chunked scan's 128 steps),
  then as one-token steps carrying ``(ssm, conv)``: the output, the state
  and the conv tail, on the reference's parameters in f32;
* the two Mamba init kinds, value for value;
* the smoke Jamba (two periods of 1 attention + 7 Mamba layers, MoE on
  the odd layers): the prefill, the cache it leaves and one decode step
  leaf by leaf, and the cache hooks on the reference's bf16 caches bit for
  bit (the conv tail is in the activations' dtype after a prefill and f32
  in ``init_cache``); what ``lilac.compile`` detects in its decode step
  beside the reference (the same, plus one ``moe_ffn`` a MoE layer:
  ROADMAP R6); the engine's streams against the uncompiled decode at its
  bucket.  Its forward logits are ``test_torch_archs.py``'s Jamba case;
* bf16 against f32, layer by layer (``chip_smoke.mamba_layers``): both
  packages' residual streams part from their f32 copies alike, each Mamba
  layer's bf16 decode stays within ``chip_smoke.MAMBA_BF16_LAYER_RTOL`` of
  its forward on its own inputs, and a decode whose state is rounded to
  bf16 between steps exceeds that bound.

Run the file to read the last two at the published width of one Mamba
mixer (d_model 4,096, d_state 16) on unit-RMS inputs, for the port and
the reference, with and without an extra bf16 rounding of the state:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_mamba.py \\
        --prompt 512 --steps 32
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
from repro import lilac as jlilac
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.models import mamba as JM
from repro.models import spec as JS
from repro.models import transformer as JT
from repro_torch import lilac
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import faults
from repro_torch.core import plan as P
from repro_torch.core.harness import REGISTRY
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import build_model
from repro_torch.models import mamba as M
from repro_torch.models.factory import params_from_numpy, to_tensor
from repro_torch.models.spec import init_params, leaves, tree_map

ARCH = "jamba-v0.1-52b"
BF16_SMALL = dict(n_layers=8, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=512, moe_experts=4, vocab=1024)


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    # the port's stores in this test's directory, no ambient chaos plan
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()
    yield
    P.reset_shared_plan_caches()


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else to_tensor(v)
            for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the block ----------------------------------------------------------------

def _block_params(d, seed=0):
    """The reference's Mamba parameters in f32, in both packages."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JS.init_params(JM.mamba_spec(d), jax.random.key(seed)))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_mamba_block_matches_the_reference():
    """Over 150 steps (the reference's chunked scan takes two chunks), then
    from the state after 130 inputs one token at a time: each step's
    output, state and conv tail within 2e-5 of the reference's (f32), and
    the steps within 1e-5 of the port's own sequence output."""
    d, B, S, pre = 64, 2, 150, 130
    jp, tp = _block_params(d)
    di = 2 * d
    x = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
    zeros = (np.zeros((B, di, 16), np.float32),
             np.zeros((B, JM.CONV_K - 1, di), np.float32))
    jout, (jssm, jtail) = JM.mamba_block(jp, jnp.asarray(x),
                                         tuple(map(jnp.asarray, zeros)))
    with torch.no_grad():
        tout, (tssm, ttail) = M.mamba_block(
            tp, torch.from_numpy(x), tuple(map(torch.from_numpy, zeros)))
    _close(tout.numpy(), jout, 2e-5)
    _close(tssm.numpy(), jssm, 2e-5)
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    jstate = JM.mamba_block(jp, jnp.asarray(x[:, :pre]),
                            tuple(map(jnp.asarray, zeros)))[1]
    with torch.no_grad():
        tstate = M.mamba_block(tp, torch.from_numpy(x[:, :pre]),
                               tuple(map(torch.from_numpy, zeros)))[1]
        for t in range(pre, S):
            jy, jstate = JM.mamba_block(jp, jnp.asarray(x[:, t:t + 1]),
                                        jstate)
            ty, tstate = M.mamba_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                       tstate)
            _close(ty.numpy(), jy, 2e-5)
            _close(tstate[0].numpy(), jstate[0], 2e-5)
            np.testing.assert_array_equal(tstate[1].numpy(),
                                          np.asarray(jstate[1]))
            _close(ty[:, 0].numpy(), tout[:, t].numpy(), 1e-5)


def test_mamba_init_kinds_are_the_references():
    """``arange_log`` (log 1..N on every row, a leading layers axis
    included) and ``dt_bias`` (log(expm1(scale))), value for value."""
    spec = {"a": ("arange_log", (3, 5, 16), 1.0),
            "b": ("dt_bias", (7,), 0.01), "c": ("dt_bias", (2, 4), 0.1)}
    jspec = {k: JS.ParamSpec(s, (None,) * len(s), dtype=jnp.float32,
                             init=i, scale=c) for k, (i, s, c) in spec.items()}
    from repro_torch.models.spec import ParamSpec
    tspec = {k: ParamSpec(s, (None,) * len(s), dtype=torch.float32,
                          init=i, scale=c) for k, (i, s, c) in spec.items()}
    want = JS.init_params(jspec, jax.random.key(0))
    got = init_params(tspec, torch.Generator().manual_seed(0))
    for k in spec:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(
        torch.nn.functional.softplus(got["b"]).numpy(), 0.01, rtol=1e-6)


# -- the smoke Jamba ----------------------------------------------------------

def _pair(**over):
    """(reference cfg, model, f32 params, bf16 params), (port cfg, model,
    f32 params)."""
    jcfg = jsmoke(jget_arch(ARCH)).replace(**over)
    cfg = smoke_config(get_arch(ARCH)).replace(**over)
    jm = jbuild_model(jcfg)
    raw = jm.init(jax.random.key(0))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), raw)
    tm = build_model(cfg)
    return (jcfg, jm, jp, raw), (cfg, tm, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp)))


def test_jamba_prefill_decode_and_cache_hooks_match_the_reference():
    """The prefill's logits and every cache leaf (Mamba's ``ssm`` / ``conv``,
    the attention layers' ``k`` / ``v``), then one decode step from the
    reference's cache, within 5e-5 of the largest magnitude (f32); the
    cache hooks on the reference's bf16 prefill caches bit for bit, the
    dtypes included."""
    (jcfg, jm, jp, raw), (cfg, tm, tp) = _pair()
    toks = np.random.default_rng(6).integers(1, 256, (2, 7)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, 5e-5)
    jflat, tflat = dict(leaves(_np_tree(jc))), dict(leaves(tc))
    assert sorted(jflat) == sorted(tflat)
    assert {k.split("/")[1] for k in jflat} == {"ssm", "conv", "k", "v"}
    for k, a in jflat.items():
        assert tuple(tflat[k].shape) == a.shape, k
        _close(tflat[k].numpy(), a, 5e-5)
    jcache = jm.cache_from_prefill(jc, 7, 16)
    step = np.array([[3], [5]], np.int32)
    jlo, jnc = jm.decode(jp, jcache, jnp.asarray(step), jnp.int32(7))
    with torch.no_grad():
        tlo, tnc = tm.decode(tp, _torch_tree(_np_tree(jcache)),
                             torch.from_numpy(step), torch.tensor(7))
    _close(tlo.numpy(), jlo, 5e-5)
    tnflat = dict(leaves(tnc))
    for k, a in dict(leaves(_np_tree(jnc))).items():
        _close(tnflat[k].numpy(), a, 5e-5)

    # the hooks, on the reference's own bf16 caches
    _, jcb = jm.prefill(raw, {"tokens": jnp.asarray(toks)})
    tcb = _torch_tree(_np_tree(jcb))
    assert tcb["b0"]["conv"].dtype == torch.bfloat16

    def same(jtree, ttree):
        jf, tf = dict(leaves(_np_tree(jtree))), dict(leaves(ttree))
        assert jf.keys() == tf.keys()
        for k, a in jf.items():
            assert tuple(tf[k].shape) == a.shape, k
            assert tf[k].dtype == to_tensor(a).dtype, k
            np.testing.assert_array_equal(tf[k].float().numpy(),
                                          np.asarray(a, np.float32), err_msg=k)

    jrow = jm.cache_from_prefill(jax.tree.map(lambda a: a[:, :1], jcb), 7, 16)
    trow = tm.cache_from_prefill(
        tree_map(lambda a: a[:, :1].clone(), tcb), 7, 16)
    same(jrow, trow)
    jb = jm.cache_set_slot(jm.init_cache(3, 16), 2, jrow)
    tb = tm.cache_set_slot(tm.init_cache(3, 16), 2, trow)
    same(jb, tb)
    assert tb["p0"]["b0"]["conv"].dtype == torch.float32
    jb, tb = jm.cache_move_slot(jb, 2, 0), tm.cache_move_slot(tb, 2, 0)
    same(jb, tb)
    for B, S in ((4, 32), (1, 8), (2, 16)):
        jb = jm.cache_resize(jb, B=B, max_seq=S)
        tb = tm.cache_resize(tb, B=B, max_seq=S)
        same(jb, tb)


def test_jamba_decode_step_detection_matches_the_reference():
    """What ``lilac.compile`` finds in one smoke Jamba decode step (the
    dense-dispatch MoE, ``naive_flat``): one ``moe_ffn`` on each of the 8
    MoE layers and nothing else, so no dot, GEMV or unrolled-loop match
    fires on a Mamba or attention op.  The reference finds no ``moe_ffn``
    (R6) and one dot product a MoE layer, over the E experts of the
    router's load-balancing loss, which the decode step discards: a jaxpr
    keeps dead code, the port's trace drops it before detection (R8).
    The compiled step's logits within 5e-5 of the reference's."""
    (jcfg, jm, jp, _), (cfg, tm, tp) = _pair(moe_decode_impl="naive_flat")
    jc = jm.init_cache(2, 8)
    tc = _torch_tree(_np_tree(jc))
    tok = np.array([[1], [2]], np.int32)
    jf = jlilac.compile(jm.decode, mode="host", plan_cache="off")
    jlo, _ = jf(jp, jc, jnp.asarray(tok), jnp.int32(3))
    tf = lilac.compile(tm.decode, mode="host", plan_cache="off",
                       platform="cpu")
    tlo, _ = tf(tp, tc, torch.from_numpy(tok), torch.tensor(3))
    moe_layers = sum(ff == "moe" for _, ff in JT.arch_pattern(jcfg)) \
        * JT.n_periods(jcfg)
    assert moe_layers == 8
    assert [(m.computation, m.binding["length"])
            for m in jf.last_report.matches] == \
        [("dotproduct", jcfg.moe_experts)] * moe_layers
    assert [m.computation for m in tf.last_report.matches] == \
        ["moe_ffn"] * moe_layers
    _close(tlo.numpy(), jlo, 5e-5)


def test_jamba_engine_streams_equal_the_teacher_forced_decode():
    """``build_engine("jamba-v0.1-52b", device="cpu")`` (the smoke model,
    its decode compiled) serving three requests of equal length at one
    bucket: each stream equals the uncompiled decode teacher-forced at
    that bucket from the same prefills.  Its 8 MoE layers run the
    ``dense`` harness, the dispatch the decode spells, so that the bits are
    the uncompiled decode's: the CPU's default harness (``torch.capacity``)
    rounds the bf16 products otherwise, and a near tie (0.006 between the
    two largest logits) then takes the other token."""
    from repro_torch.serve import BucketPolicy, Request, ServeConfig
    from repro_torch.serve import build_engine

    policy = BucketPolicy(batch=(4,), seq=(32,))
    eng = build_engine(ARCH, seed=2, device="cpu", config=ServeConfig(
        buckets=policy, prewarm_on_start=False, plan_cache="off",
        policy="dense"))
    model, params = eng.model, eng.params
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(1, model.cfg.vocab, p)
                    .astype(np.int32), max_new_tokens=6) for p in (5, 3, 9)]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    assert all(len(r.tokens) == 6 and not r.failed for r in reqs)
    assert [n for _, n in eng._decode.last_selections] == ["dense"] * 8
    with torch.no_grad():
        cache, firsts = C._install(model, params, reqs, (4, 32),
                                   torch.device("cpu"))
        assert all(firsts)
        for t in range(5):
            tok, pos = C._step_inputs(reqs, 4, t, torch.device("cpu"))
            logits, cache = model.decode(params, cache, tok, pos)
            assert [int(logits[i].argmax()) for i in range(3)] == \
                [r.tokens[t + 1] for r in reqs], t


# -- bf16 against f32, layer by layer -----------------------------------------

def reference_layers(jcfg, params, tokens):
    """The reference's residual stream after each layer (embedding first)
    through its own ``apply_block``, the MoE the naive dense dispatch."""
    x = params["embed"][jnp.asarray(tokens)]
    B, S = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    xs = [np.asarray(x.astype(jnp.float32))]
    pattern = JT.arch_pattern(jcfg)
    for j in range(JT.n_periods(jcfg)):
        period = jax.tree.map(lambda a: a[j], params["blocks"])
        for i, (mixer, ffn) in enumerate(pattern):
            x, _, _ = JT.apply_block(jcfg, period[f"b{i}"], x, mixer=mixer,
                                     ffn=ffn, positions=positions,
                                     moe_impl="naive")
            xs.append(np.asarray(x.astype(jnp.float32)))
    return xs


def bf16_readings(over, prompt: int, steps: int, seed: int = 23):
    """The port's bf16 parameters (from ``seed``) and their f32 copy, in
    both packages: the residual streams' bf16-to-f32 relative L2 per
    layer, and the port's Mamba decode against its forward per layer
    (``chip_smoke.mamba_layers``) in bf16 and f32."""
    cfg = get_arch(ARCH).replace(**over)
    jcfg = jget_arch(ARCH).replace(**over)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed), "cpu")
    tokens = torch.randint(1, cfg.vocab, (2, prompt + steps),
                           generator=torch.Generator().manual_seed(seed + 6),
                           dtype=torch.int32)
    with torch.no_grad():
        r = C.mamba_layers(cfg, params, tokens, prompt, steps, f32=True)
    tb = [x.float().numpy() for x in r["model"]["streams"]]
    tf = [x.float().numpy() for x in r["f32"]["streams"]]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jb = tree_map(lambda a: jnp.asarray(a.float().numpy(), jdt[a.dtype]),
                  params)
    jf = tree_map(lambda a: jnp.asarray(a.float().numpy()), params)
    rb = reference_layers(jcfg, jb, tokens.numpy())
    rf = reference_layers(jcfg.replace(param_dtype=jnp.float32), jf,
                          tokens.numpy())
    return {"port_bf16_to_f32": [_rel(b, f) for b, f in zip(tb[1:], tf[1:])],
            "ref_bf16_to_f32": [_rel(b, f) for b, f in zip(rb[1:], rf[1:])],
            "port_to_ref_f32": [_rel(t, r) for t, r in zip(tf[1:], rf[1:])],
            "decode_bf16": r["model"]["decode"],
            "decode_f32": r["f32"]["decode"]}


@pytest.fixture(scope="module")
def small():
    return bf16_readings(BF16_SMALL, prompt=48, steps=8)


def test_both_packages_spread_alike_with_depth(small):
    """The bf16 model's residual stream parts from its f32 copy by the
    same amount in both packages, within a factor 1.5 at every layer, and
    the f32 streams agree to 1e-4."""
    p, r = small["port_bf16_to_f32"], small["ref_bf16_to_f32"]
    assert len(p) == BF16_SMALL["n_layers"]
    for a, b in zip(p, r):
        assert 1 / 1.5 <= a / b <= 1.5, (p, r)
    assert max(small["port_to_ref_f32"]) <= 1e-4, small["port_to_ref_f32"]


def test_each_mamba_layer_decodes_as_its_forward(small):
    """Each of the 7 Mamba layers on its own inputs: the bf16 decode
    within ``MAMBA_BF16_LAYER_RTOL`` of the forward, the f32 within
    1e-5."""
    assert sorted(small["decode_bf16"]) == [0, 1, 2, 3, 5, 6, 7]
    assert max(small["decode_bf16"].values()) <= C.MAMBA_BF16_LAYER_RTOL, \
        small
    assert max(small["decode_f32"].values()) <= 1e-5, small


def test_a_bf16_state_in_the_decode_exceeds_the_layer_bound(monkeypatch):
    """The per-layer bound catches a fault the f32 run cannot show: the
    Mamba state rounded to bf16 between one-token steps."""
    block = M.mamba_block

    def rounded(p, x, state, d_state=16):
        y, (ssm, conv) = block(p, x, state, d_state)
        if x.shape[1] == 1:
            ssm = ssm.to(x.dtype).float()
        return y, (ssm, conv)

    monkeypatch.setattr(M, "mamba_block", rounded)
    cfg = get_arch(ARCH).replace(**BF16_SMALL)
    params = build_model(cfg).init(torch.Generator().manual_seed(23), "cpu")
    tokens = torch.randint(1, cfg.vocab, (2, 80),
                           generator=torch.Generator().manual_seed(29),
                           dtype=torch.int32)
    with torch.no_grad():
        r = C.mamba_layers(cfg, params, tokens, 48, 32)
    assert max(r["model"]["decode"].values()) > C.MAMBA_BF16_LAYER_RTOL, r


# -- run as a script: one Mamba mixer at the published width ----------------

def mixer_readings(d: int, prompt: int, steps: int, seed: int = 31):
    """One Mamba mixer at width ``d`` on unit-RMS inputs (an RMSNormed
    layer input): its decode against its forward, relative L2 over
    ``steps`` steps, in bf16 for the port and the reference, in f32 for
    the port, and in bf16 with the state rounded to bf16 between steps."""
    spec = M.mamba_spec(d)
    p = init_params(spec, torch.Generator().manual_seed(seed))
    x = torch.randn((2, prompt + steps, d),
                    generator=torch.Generator().manual_seed(seed + 1))
    x = x / x.pow(2).mean(-1, keepdim=True).sqrt()

    def port(p, x, round_state=False):
        zero = (torch.zeros((2, 2 * d, 16)), torch.zeros((2, 3, 2 * d)))
        full, _ = M.mamba_block(p, x, zero)
        _, st = M.mamba_block(p, x[:, :prompt], zero)
        got = []
        for t in range(prompt, prompt + steps):
            y, st = M.mamba_block(p, x[:, t:t + 1], st)
            if round_state:
                st = (st[0].to(x.dtype).float(), st[1])
            got.append(y)
        return C.rel_l2(torch.cat(got, 1), full[:, prompt:])

    def ref(p, x):
        jp = {k: jnp.asarray(v.float().numpy(),
                             jnp.bfloat16 if v.dtype == torch.bfloat16
                             else jnp.float32) for k, v in p.items()}
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        zero = (jnp.zeros((2, 2 * d, 16)), jnp.zeros((2, 3, 2 * d)))
        full, _ = JM.mamba_block(jp, jx, zero)
        _, st = JM.mamba_block(jp, jx[:, :prompt], zero)
        got = []
        for t in range(prompt, prompt + steps):
            y, st = JM.mamba_block(jp, jx[:, t:t + 1], st)
            got.append(np.asarray(y.astype(jnp.float32)))
        return _rel(np.concatenate(got, 1),
                    np.asarray(full[:, prompt:].astype(jnp.float32)))

    xb = x.to(torch.bfloat16)
    p32 = {k: v.float() for k, v in p.items()}
    with torch.no_grad():
        return {"port_bf16": port(p, xb), "ref_bf16": ref(p, xb),
                "port_f32": port(p32, x),
                "port_bf16_state_rounded": port(p, xb, round_state=True)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=4096)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    a = ap.parse_args()
    for s in range(a.seeds):
        r = mixer_readings(a.d_model, a.prompt, a.steps, seed=31 + s)
        print(f"seed {31 + s}: " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in r.items()))


if __name__ == "__main__":
    main()
