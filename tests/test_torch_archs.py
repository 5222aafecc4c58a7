"""The port's ten registered architectures against the JAX package: the
cases of ``tests/test_archs.py`` on ``repro_torch`` (a reduced same-family
config: one forward and one AdamW step that moves the loss, three decode
steps, a full prefill against the teacher-forced decode at the
reference's tolerances with the argmax exact, the shape-skip table, the
advertised parameter counts), then the parity of each smoke model with
the reference on the reference's own parameters (``params_from_numpy``,
cast to f32 on both sides): the forward's logits at every position,
within 1e-4 of their largest magnitude (measured: 1.0e-6 for RWKV-6 to
5.2e-5 for Jamba), with grouped-query (kv 2 of 4 heads) and multi-query
(granite-34b, kv 1) attention among them, HuBERT and InternVL2 from
precomputed embeddings and HuBERT's attention bidirectional; every arch
and LM shape's ``input_specs`` against the reference's
``ShapeDtypeStruct``s; RWKV-6's prefill, one decode step and its cache
hooks, its decode step's detection beside the reference's, the chunked
scan's checkpointed gradient, and ``init_params`` refusing an init kind
it does not know.  Jamba's own cases are in ``test_torch_mamba.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.configs import SHAPES as JSHAPES, all_archs as jall_archs
from repro.configs import get_arch as jget_arch
from repro.configs import shape_skips as jshape_skips, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.models import transformer as JT
from repro_torch import lilac
from repro_torch.configs import SHAPES, all_archs, get_arch, shape_skips
from repro_torch.configs import smoke_config
from repro_torch.core import faults
from repro_torch.core import plan as P
from repro_torch.core.harness import REGISTRY
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.factory import params_from_numpy
from repro_torch.models.spec import ParamSpec, init_params, leaves
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import value_and_grad

ARCHS = sorted(all_archs())
ADVERTISED = {            # tests/test_archs.py:134
    "rwkv6-1.6b": (1.5e9, 1.9e9),
    "internvl2-2b": (1.7e9, 2.2e9),
    "granite-moe-3b-a800m": (3.0e9, 3.7e9),
    "olmoe-1b-7b": (6.4e9, 7.4e9),
    "granite-8b": (7.5e9, 9.0e9),
    "mistral-large-123b": (118e9, 128e9),
    "granite-34b": (33e9, 50e9),
    "olmo-1b": (1.1e9, 1.5e9),
    "jamba-v0.1-52b": (48e9, 56e9),
    "hubert-xlarge": (0.9e9, 1.4e9),
}
# the reference skips decode for an encoder ("encoder-only: no decode
# step"), and prefill against decode also for a stub frontend ("stub
# frontends feed embeddings; decode consumes tokens"): those archs are
# not among these cases
DECODE_ARCHS = [a for a in ARCHS if get_arch(a).causal]
PREFILL_DECODE_ARCHS = [a for a in DECODE_ARCHS
                        if get_arch(a).frontend == "none"]
LOGIT_RTOL = 1e-4


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


def _batch(cfg, B=2, S=16, seed=0):
    """The reference's batch: f32 embeddings for a stub frontend, else
    tokens, and labels."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "stub":
        first = ("embeds", rng.standard_normal((B, S, cfg.d_model))
                 .astype(np.float32))
    else:
        first = ("tokens", rng.integers(0, cfg.vocab, (B, S))
                 .astype(np.int32))
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {first[0]: torch.from_numpy(first[1]),
            "labels": torch.from_numpy(labels)}


def _init(model, seed):
    return model.init(torch.Generator().manual_seed(seed), "cpu")


# -- tests/test_archs.py on the port ------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    cfg = smoke_config(get_arch(arch))
    model = build_model(cfg)
    params = _init(model, 0)
    batch = _batch(cfg)
    if "embeds" in batch:
        # a vlm's token table is its decode's: a forward from embeddings
        # does not read it, and value_and_grad refuses a parameter that
        # no gradient reaches (the reference gives it a zero gradient)
        params.pop("embed", None)
    loss, grads = value_and_grad(model.loss_fn)(params, batch)
    assert torch.isfinite(loss), arch
    gn = sum(float(torch.sum(torch.square(g.float())))
             for _, g in leaves(grads))
    assert np.isfinite(gn) and gn > 0, arch
    ocfg = AdamWConfig(lr=1e-2, total_steps=10, warmup_steps=0)
    new_params, _, _ = adamw_update(ocfg, grads, adamw_init(ocfg, params),
                                    params)
    with torch.no_grad():
        loss2 = model.loss_fn(new_params, batch)
    assert torch.isfinite(loss2), arch
    assert float(loss2) != float(loss), arch


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_smoke_decode(arch):
    cfg = smoke_config(get_arch(arch))
    model = build_model(cfg)
    params = _init(model, 0)
    B, cache_len = 2, 24
    cache = model.init_cache(B, cache_len)
    logits = None
    with torch.no_grad():
        for pos in range(3):
            tok = torch.full((B, 1), pos + 1, dtype=torch.int32)
            logits, cache = model.decode(params, cache, tok,
                                         torch.tensor(pos))
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), arch


@pytest.mark.parametrize("arch", PREFILL_DECODE_ARCHS)
def test_prefill_matches_decode(arch):
    """Teacher-forced decode agrees with a full prefill at the reference's
    tolerances (3e-1 for the recurrent and MoE families, 5e-2 dense), the
    argmax exactly.  Jamba too: the reference expects this case to fail
    for XLA-CPU's fused logistic (ROADMAP R4), which eager torch does not
    have."""
    cfg = smoke_config(get_arch(arch))
    if cfg.moe_experts:
        # the grouped dispatch's capacity drops depend on the dispatch
        # group: the dense dispatch on both paths drops none
        cfg = cfg.replace(moe_impl="naive", moe_decode_impl="naive_flat")
    model = build_model(cfg)
    params = _init(model, 1)
    B, S = 2, 8
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S))
                              .astype(np.int32))
    with torch.no_grad():
        logits_pre, _ = model.prefill(params, {"tokens": tokens})
        cache = model.init_cache(B, S)
        for pos in range(S):
            logits_dec, cache = model.decode(params, cache,
                                             tokens[:, pos:pos + 1],
                                             torch.tensor(pos))
    tol = 3e-1 if cfg.family in ("ssm", "hybrid") or cfg.moe_experts \
        else 5e-2
    np.testing.assert_allclose(logits_dec.numpy(), logits_pre.numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(logits_dec.argmax(-1).numpy(),
                                  logits_pre.argmax(-1).numpy())


def test_param_counts_match_advertised_sizes():
    """Specs only: no parameter of the 123 B model materializes."""
    assert set(ADVERTISED) == set(ARCHS)
    for arch, (lo, hi) in ADVERTISED.items():
        n = build_model(get_arch(arch)).param_count()
        assert lo <= n <= hi, (arch, n)
        assert n == jbuild_model(jget_arch(arch)).param_count(), arch


def test_configs_are_the_references():
    """Every field the port keeps, and the source strings, verbatim; the
    head width, attention direction, frontend, Mamba state and hybrid
    period compared with the reference's, and RoPE's base the constant
    1e4 the port uses; the smoke reductions equal too."""
    assert set(ARCHS) == set(jall_archs())
    for arch in ARCHS:
        cfg, ref = get_arch(arch), jget_arch(arch)
        for c, r in ((cfg, ref), (smoke_config(cfg), jsmoke(ref))):
            for f in ("family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "moe_experts",
                      "moe_topk", "norm", "source", "kv_chunk", "head_dim",
                      "causal", "frontend", "d_state", "attn_layer_period",
                      "attn_layer_offset", "moe_layer_period"):
                assert getattr(c, f) == getattr(r, f), (arch, f)
            assert c.resolved_head_dim == r.resolved_head_dim, arch
        assert ref.rope_theta == 1e4


def test_shape_skip_table():
    """The skip table equals the reference's entry by entry (9 of 40
    skipped: 500k decode for the full-attention archs, decode for the
    encoder)."""
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in SHAPES.values()] == \
        [(s.name, s.seq_len, s.global_batch, s.kind)
         for s in JSHAPES.values()]
    skips = {(a, s): shape_skips(get_arch(a), SHAPES[s])
             for a in ARCHS for s in SHAPES}
    assert skips == {(a, s): jshape_skips(jget_arch(a), JSHAPES[s])
                     for a in ARCHS for s in JSHAPES}
    assert sum(1 for v in skips.values() if v) == 9
    assert skips[("jamba-v0.1-52b", "long_500k")] is None
    assert skips[("hubert-xlarge", "decode_32k")] is not None


_JDTYPES = {"int32": torch.int32, "float32": torch.float32,
            "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """Every LM shape's inputs, leaf for leaf: the reference's
    ``ShapeDtypeStruct`` shapes and dtypes, as tensors on the ``meta``
    device (no storage; the 32k decode caches of the large archs would
    take terabytes)."""
    model, jmodel = build_model(get_arch(arch)), jbuild_model(jget_arch(arch))
    for name in SHAPES:
        got = dict(leaves(model.input_specs(SHAPES[name])))
        want = dict(leaves(_np_tree_specs(
            jmodel.input_specs(JSHAPES[name]))))
        assert got.keys() == want.keys(), (arch, name)
        for k, (shape, dtype) in want.items():
            assert got[k].device.type == "meta", (arch, name, k)
            assert tuple(got[k].shape) == shape, (arch, name, k)
            assert got[k].dtype == _JDTYPES[dtype], (arch, name, k)


def _np_tree_specs(tree):
    return {k: _np_tree_specs(v) if isinstance(v, dict)
            else (tuple(v.shape), jnp.dtype(v.dtype).name)
            for k, v in tree.items()}


# -- parity with the reference on its parameters ------------------------------

def _pair(arch, **over):
    """(reference cfg, model, f32 params), (port cfg, model, params)."""
    jcfg = jsmoke(jget_arch(arch)).replace(**over)
    cfg = smoke_config(get_arch(arch)).replace(**over)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    tm = build_model(cfg)
    return (jcfg, jm, jp), (cfg, tm, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp)))


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


FORWARD_CASES = [(a, {}) for a in ARCHS] + [
    ("granite-8b", {"n_kv_heads": 2}),            # GQA: 4 heads on 2
    ("granite-moe-3b-a800m", {"n_kv_heads": 2}),
]


def _inputs(cfg, seed=5, B=2, S=16):
    """The same inputs for both packages: tokens, or f32 embeddings for a
    stub frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "stub":
        a = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}
    a = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}


def _logits(jcfg, jp, jin, cfg, tp, tin):
    jx, _, _ = JT.forward(jcfg, jp, jin)
    want = np.asarray(jnp.einsum("bsd,dv->bsv", jx, jp["unembed"]))
    with torch.no_grad():
        tx, _, _ = T.forward(cfg, tp, tin)
        got = torch.einsum("bsd,dv->bsv", tx, tp["unembed"]).numpy()
    return got, want


@pytest.mark.parametrize("arch,over", FORWARD_CASES,
                         ids=[a + ("-kv2" if o else "")
                              for a, o in FORWARD_CASES])
def test_forward_logits_match_the_reference(arch, over):
    """Tokens, or (HuBERT, InternVL2) precomputed embeddings, through
    both forwards on the reference's parameters."""
    (jcfg, _, jp), (cfg, _, tp) = _pair(arch, **over)
    jin, tin = _inputs(cfg)
    _close(*_logits(jcfg, jp, jin, cfg, tp, tin), LOGIT_RTOL)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_attention_direction_matches_the_reference(arch):
    """Changing the last position's embedding moves the first position's
    output in HuBERT (bidirectional) and not in InternVL2 (causal), in
    both packages, and the edited forwards still agree."""
    (jcfg, _, jp), (cfg, _, tp) = _pair(arch)
    jin, tin = _inputs(cfg)
    got, want = _logits(jcfg, jp, jin, cfg, tp, tin)
    edited = tin["embeds"].clone()
    edited[:, -1] += 1.0
    got2, want2 = _logits(jcfg, jp, {"embeds": jnp.asarray(edited.numpy())},
                          cfg, tp, {"embeds": edited})
    _close(got2, want2, LOGIT_RTOL)
    for a, b in ((got, got2), (want, want2)):
        moved = np.abs(a[:, 0] - b[:, 0]).max()
        if cfg.causal:
            assert moved == 0.0, (arch, moved)
        else:
            assert moved > 1e-3 * np.abs(a).max(), (arch, moved)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_rwkv_prefill_decode_and_cache_hooks_match_the_reference():
    """RWKV-6's prefill (logits and the collected state and carries), one
    decode step from the reference's cache, and the cache hooks: the
    state and carry leaves pass through ``cache_from_prefill``,
    ``cache_set_slot``, ``cache_move_slot`` and ``cache_resize`` as the
    reference's do (bit for bit), with no sequence axis to pad."""
    (_, jm, jp), (_, tm, tp) = _pair("rwkv6-1.6b")
    toks = np.random.default_rng(6).integers(1, 256, (2, 7)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, 5e-5)
    jflat, tflat = dict(leaves(_np_tree(jc))), dict(leaves(tc))
    assert sorted(jflat) == sorted(tflat) == \
        ["b0/last_cm", "b0/last_tm", "b0/s"]
    for k, a in jflat.items():
        assert tuple(tflat[k].shape) == a.shape
        _close(tflat[k].numpy(), a, 5e-5)
    # one decode step from the reference's own cache
    jcache = jm.cache_from_prefill(jc, 7, 16)
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    step = np.array([[3], [5]], np.int32)
    jlo, jnc = jm.decode(jp, jcache, jnp.asarray(step), jnp.int32(7))
    with torch.no_grad():
        tlo, tnc = tm.decode(tp, tcache, torch.from_numpy(step),
                             torch.tensor(7))
    _close(tlo.numpy(), jlo, 5e-5)
    for k, a in dict(leaves(_np_tree(jnc))).items():
        _close(dict(leaves(tnc))[k].numpy(), a, 5e-5)
    # the hooks on the same caches, bit for bit
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)

    def same(jtree, ttree):
        jf, tf = dict(leaves(_np_tree(jtree))), dict(leaves(ttree))
        assert jf.keys() == tf.keys()
        for k, a in jf.items():
            assert tuple(tf[k].shape) == a.shape, k
            assert tf[k].dtype == torch.from_numpy(np.array(a)).dtype, k
            np.testing.assert_array_equal(tf[k].numpy(), a, err_msg=k)

    jrow = jm.cache_from_prefill(jax.tree.map(lambda a: a[:, :1], jc), 7, 16)
    trow = tm.cache_from_prefill(
        jax.tree.map(lambda a: a[:, :1].clone(), tc), 7, 16)
    same(jrow, trow)
    jb = jm.cache_set_slot(jm.init_cache(3, 16), 2, jrow)
    tb = tm.cache_set_slot(tm.init_cache(3, 16), 2, trow)
    same(jb, tb)
    jb, tb = jm.cache_move_slot(jb, 2, 0), tm.cache_move_slot(tb, 2, 0)
    same(jb, tb)
    for B, S in ((4, 32), (1, 8), (2, 16)):
        jb = jm.cache_resize(jb, B=B, max_seq=S)
        tb = tm.cache_resize(tb, B=B, max_seq=S)
        same(jb, tb)


def test_rwkv_decode_step_detection_matches_the_reference():
    """What lilac.compile finds in one smoke RWKV-6 decode step: the same
    computation kinds as the reference's compiled decode (none: the
    recurrence's products are dense, per head and per token)."""
    (_, jm, jp), (_, tm, tp) = _pair("rwkv6-1.6b")
    jc = jm.init_cache(2, 8)
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok = np.array([[1], [2]], np.int32)
    jf = jlilac.compile(jm.decode, mode="host", plan_cache="off")
    jlo, _ = jf(jp, jc, jnp.asarray(tok), jnp.int32(3))
    tf = lilac.compile(tm.decode, mode="host", plan_cache="off",
                       platform="cpu")
    tlo, _ = tf(tp, tc, torch.from_numpy(tok), torch.tensor(3))
    kinds = sorted(m.computation for m in tf.last_report.matches)
    assert kinds == sorted(m.computation for m in jf.last_report.matches)
    assert kinds == []
    _close(tlo.numpy(), jlo, 5e-5)


def test_chunked_scan_checkpoints_without_changing_the_gradient():
    """Past ``chunk`` steps each chunk runs under checkpoint: the carry,
    the outputs and their gradients equal the plain loop's."""
    g = torch.Generator().manual_seed(0)
    xs = (torch.randn(11, 3, generator=g, requires_grad=True),)
    w = torch.randn(3, generator=g, requires_grad=True)

    def step(c, x):
        c = torch.tanh(c * w + x[0])
        return c, c.sum()

    init = torch.zeros(3)
    res = [L.chunked_scan(step, init, xs, chunk=c) for c in (4, 128)]
    for (c1, y1), (c2, y2) in [res]:
        assert torch.equal(c1, c2) and torch.equal(y1, y2)
    grads = [torch.autograd.grad(c.sum() + y.sum(), (xs[0], w))
             for c, y in res]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_rwkv_engine_streams_equal_the_teacher_forced_decode():
    """The serving engine on the smoke RWKV-6 (its recurrent cache
    through install, re-bucketing and compaction): each request's stream
    equals its own greedy prefill + decode."""
    from repro_torch.serve import BucketPolicy, Request, ServeConfig
    from repro_torch.serve import Engine

    cfg = smoke_config(get_arch("rwkv6-1.6b"))
    model = build_model(cfg)
    params = _init(model, 2)
    rng = np.random.default_rng(3)
    specs = [(rng.integers(1, cfg.vocab, p).astype(np.int32), n)
             for p, n in ((5, 4), (3, 6), (7, 3))]
    eng = Engine(model, params, ServeConfig(
        buckets=BucketPolicy(batch=(1, 2), seq=(16,)),
        prewarm_on_start=False, plan_cache="off", jit_prefill=False))
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    for r, (prompt, n) in zip(reqs, specs):
        with torch.no_grad():
            logits, caches = model.prefill(
                params, {"tokens": torch.from_numpy(prompt[None])})
            cache = model.cache_from_prefill(caches, len(prompt), 16)
            want = [int(logits[0].argmax())]
            for t in range(n - 1):
                logits, cache = model.decode(
                    params, cache, torch.tensor([[want[-1]]]),
                    torch.tensor(len(prompt) + t))
                want.append(int(logits[0].argmax()))
        assert list(r.tokens) == want


def test_init_params_raises_on_an_unknown_init_kind():
    spec = {"a": ParamSpec((2, 3), (None, None)),
            "b": ParamSpec((4,), (None,), init="xavier")}
    with pytest.raises(ValueError, match="unknown init kind"):
        init_params(spec, torch.Generator().manual_seed(0))
    got = init_params({"a": spec["a"]}, torch.Generator().manual_seed(0))
    assert got["a"].shape == (2, 3)
