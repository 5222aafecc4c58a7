"""The reference's ``jax.jit`` entry points as ``torch.compile`` in the
port, on the CPU with the ``aot_eager`` backend, held against the
uncompiled port and the JAX package:

* ``train_loop``'s compiled step (one graph: forward, backward by
  ``torch.func.grad_and_value``, AdamW) on the smoke OLMoE with
  ``moe_impl="lilac"`` (its inner compile on ``cuda.gmm``, whose plain
  version on the CPU drops nothing), on the reference's parameters
  (``params_from_numpy``): 3 steps bit for bit the eager loop's; the
  first step's loss within 1e-4 relative and its update within relative
  L2 5e-3 of the reference's jitted ``train_loop`` (the tolerances of
  ``test_train_step_matches_reference``); ``lilac_torch::moe_ffn`` in the
  compiled graph and no graph break; a restart repeating the losses; a
  parameter the loss does not reach still raising;
* the engine's ``jit_prefill`` / ``prefill_lengths``: the tokens of the
  eager engine and of the reference's engine, nothing compiled on the
  request path at a prewarmed length, and more prompt lengths than
  dynamo's recompile limit each running its own compiled graph;
* ``core.jit.Entry`` raising past the recompile limit, never running
  uncompiled."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._dynamo.testing import AotEagerAndRecordGraphs

from repro import serve as jserve
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.train import optim as JO
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train_loop as jtrain_loop
from repro_torch import lilac
from repro_torch import serve as tserve
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import faults, jit
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import build_model, layers as L
from repro_torch.models.factory import params_from_numpy
from repro_torch.models.spec import leaves
from repro_torch.train import optim as O
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, compile_step, train_loop
from repro_torch.train.train_step import make_train_step

SEQ, BATCH, STEPS = 32, 2, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _stores(mp, root):
    mp.setenv("LILAC_TORCH_QUARANTINE_CACHE", str(root / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE", "LILAC_TORCH_REQUEST_SHADOW_RATE"):
        mp.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    mp.setenv("LILAC_TORCH_AUTOTUNE_CACHE", str(root / "autotune.json"))
    mp.setenv("LILAC_TORCH_PLAN_CACHE", str(root / "plans.json"))


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    _stores(monkeypatch, tmp_path)


def _flat(tree):
    return dict(leaves(tree))


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The compiled loop (a recording aot_eager backend, a checkpoint
    every step), the eager loop, and the reference's one jitted step, all
    from the reference's smoke OLMoE parameters and batches."""
    root = tmp_path_factory.mktemp("compiled_loop")
    with pytest.MonkeyPatch.context() as mp:
        _stores(mp, root)
        mp.setitem(L._LILAC_MOE, "cpu", lilac.compile(
            L._moe_naive_2d, platform="cpu", policy="cuda.gmm"))
        jm = jbuild_model(jsmoke(jget_arch("olmoe-1b-7b")).replace(
            moe_impl="naive"))
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.key(0)))
        cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_impl="lilac")
        model = build_model(cfg)
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
        data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                           seed=1)
        opt = O.AdamWConfig(**OPT)
        rec = AotEagerAndRecordGraphs()
        entry = compile_step(make_train_step(model, opt), rec)
        ck = root / "ck"
        lc = LoopConfig(steps=STEPS, ckpt_every=1, log_every=100,
                        ckpt_dir=str(ck), deterministic=True)
        compiled = train_loop(model, opt, lc, data.batch_at, params=params,
                              device="cpu", step_fn=entry,
                              emit=lambda s: None)
        step1 = Checkpointer(str(ck)).restore(
            1, {"params": params, "opt": O.adamw_init(opt, params)})
        shutil.rmtree(ck / "step_3")
        shutil.rmtree(ck / "step_2")
        restart = train_loop(model, opt, lc, data.batch_at, params=params,
                             device="cpu", step_fn=entry,
                             emit=lambda s: None)
        eager = train_loop(model, opt, LoopConfig(steps=STEPS, log_every=100,
                                                  deterministic=True),
                           data.batch_at, params=params, device="cpu",
                           backend=None, emit=lambda s: None)
        jres = jtrain_loop(jm, JO.AdamWConfig(**OPT),
                           JLoopConfig(steps=1, log_every=100),
                           data.batch_at, params=jax.tree.map(jnp.copy, jp),
                           emit=lambda s: None)
        yield {"params": params, "compiled": compiled, "restart": restart,
               "eager": eager, "step1": step1["params"], "reference": jres,
               "rec": rec, "entry": entry, "layers": cfg.n_layers}


def test_compiled_loop_is_the_eager_loop_bit_for_bit(runs):
    got, want = runs["compiled"], runs["eager"]
    assert len(got["history"]) == STEPS
    assert got["history"] == want["history"]
    for k, a in _flat(want["params"]).items():
        assert torch.equal(_flat(got["params"])[k], a), k
    for k, a in _flat(want["opt_state"]["mu"]).items():
        assert torch.equal(_flat(got["opt_state"]["mu"])[k], a), k
    assert want["compiled"] is None
    assert got["compiled"]["backend"] != "None"


def test_compiled_loop_first_step_is_the_references(runs):
    """The first loss within 1e-4 and the first update within relative
    L2 5e-3 of the reference's jitted loop (Adam's first step moves an
    entry whose gradient is ~0 by a sign rounding decides)."""
    jres = runs["reference"]
    np.testing.assert_allclose(runs["compiled"]["history"][0],
                               jres["history"][0], rtol=1e-4)
    old, new = _flat(runs["params"]), _flat(runs["step1"])
    num = den = 0.0
    for name, a in _jflat(jres["params"]).items():
        p0 = old[name].double().numpy()
        dj = np.asarray(a, np.float64) - p0
        dt = new[name].double().numpy() - p0
        num += float(((dj - dt) ** 2).sum())
        den += float((dj ** 2).sum())
    assert np.sqrt(num / den) < 5e-3


def test_compiled_step_is_one_graph_holding_moe_ffn(runs):
    """One graph for the step (forward, backward and AdamW), compiled
    once over both loops, no graph break; AOT's graph calls
    ``lilac_torch::moe_ffn`` once a layer (the forward's K4 call; the
    backward is the vjp clause's capacity recompute)."""
    stats = runs["compiled"]["compiled"]
    print("compiled step:", stats)
    assert stats["fullgraph"] and stats["graph_breaks"] == 0
    # the restart's steps from its checkpoint at step 1 on the same graph
    assert stats["compiles"] == 1 and runs["entry"].calls == 2 * STEPS - 1
    graphs = runs["rec"].fw_graphs
    assert len(graphs) == 1
    ops = [n.target for n in graphs[0].graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.lilac_torch.moe_ffn.default) == runs["layers"]


def test_compiled_restart_repeats_the_losses(runs):
    r = runs["restart"]
    assert r["start_step"] == 1
    assert r["history"] == runs["compiled"]["history"][1:]
    for k, a in _flat(runs["compiled"]["params"]).items():
        assert torch.equal(_flat(r["params"])[k], a), k


def test_compiled_step_raises_for_a_parameter_no_gradient_reaches():
    cfg = smoke_config(get_arch("olmo-1b"))
    model = build_model(cfg)
    loss_fn = model.loss_fn
    model.loss_fn = lambda p, b: loss_fn(
        {**p, "unembed": p["unembed"].detach()}, b)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2)
    with pytest.raises(ValueError, match="no gradient reaches.*unembed"):
        train_loop(model, O.AdamWConfig(total_steps=10),
                   LoopConfig(steps=1, log_every=100), data.batch_at,
                   device="cpu", backend="aot_eager", emit=lambda s: None)
    with pytest.raises(ValueError, match="no gradient reaches.*unembed"):
        train_loop(model, O.AdamWConfig(total_steps=10),
                   LoopConfig(steps=1, log_every=100), data.batch_at,
                   device="cpu", backend=None, emit=lambda s: None)


def test_entry_raises_past_the_recompile_limit():
    """An entry compiled at static shapes meets a ninth shape: dynamo's
    recompile limit (8) raises, the function never runs uncompiled."""
    entry = jit.Entry(lambda x: torch.sin(x) * 2, "aot_eager")
    for n in range(1, 9):
        torch.testing.assert_close(entry(torch.ones(n)),
                                   torch.sin(torch.ones(n)) * 2)
    assert entry.compiles == 8
    with pytest.raises(Exception, match="(?i)recompile"):
        entry(torch.ones(9))
    assert entry.compiles == 8
    # another entry of the same function has a cache of its own
    other = jit.Entry(entry.fn, "aot_eager")
    other(torch.ones(9))
    assert other.compiles == 1
    with pytest.raises(ValueError, match="backend"):
        jit.Entry(entry.fn, None)


# ---------------------------------------------------------------------------
# the engine's compiled admission
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_lm():
    """The smoke OLMoE of both packages on the reference's parameters
    (f32)."""
    jcfg = jsmoke(jget_arch("olmoe-1b-7b"))
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    cfg = smoke_config(get_arch("olmoe-1b-7b"))
    return jm, jp, build_model(cfg), params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


LENGTHS = (3, 5, 7)


def _serve(pkg, model, params, specs, **kw):
    eng = pkg.Engine(model, params, pkg.ServeConfig(
        buckets=pkg.BucketPolicy(batch=(1, 2), seq=(16,)), **kw))
    reqs = [pkg.Request(prompt=p, max_new_tokens=n) for p, n in specs]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    return eng, [list(r.tokens) for r in reqs]


def test_jit_prefill_engine_gives_the_eager_and_reference_tokens(small_lm):
    """Prewarmed at LENGTHS: every request's prefill, install and slot
    move run compiled graphs built during prewarm (none on the request
    path); the streams are the eager engine's and the reference's."""
    jm, jp, model, params = small_lm
    rng = np.random.default_rng(4)
    specs = [(rng.integers(1, 256, L).astype(np.int32), n)
             for L, n in ((5, 4), (3, 6), (7, 3), (5, 2), (3, 5))]
    eng, got = _serve(tserve, model, params, specs, jit_prefill=True,
                      prefill_lengths=LENGTHS, compile_backend="aot_eager")
    pw = eng.metrics.prewarm
    assert pw["prefill_warmed"] == list(LENGTHS)
    info = eng.compile_info()
    print("compiled admission:", {k: v for k, v in info.items()
                                  if k != "by_entry"})
    assert info["request_path_compiles"] == 0
    kinds = sorted(tuple(e["key"]) for e in info["by_entry"])
    assert kinds == sorted(
        [("prefill", L) for L in LENGTHS]
        + [("install", L, b, 16) for L in LENGTHS for b in (1, 2)]
        + [("move", b, 16) for b in (1, 2)])
    assert all(e["compiles"] == 1 for e in info["by_entry"])
    _, eager = _serve(tserve, model, params, specs, jit_prefill=False,
                      prefill_lengths=LENGTHS)
    _, want = _serve(jserve, jm, jp, specs, prefill_lengths=LENGTHS)
    assert got == eager == want


def test_more_prompt_lengths_than_the_recompile_limit_run_compiled(small_lm):
    """Ten prompt lengths (dynamo's recompile limit is 8): each length's
    prefill is an entry of its own that compiles once and runs its graph;
    the streams are the eager engine's."""
    _, _, model, params = small_lm
    limit = torch._dynamo.config.recompile_limit
    rng = np.random.default_rng(5)
    specs = [(rng.integers(1, 256, L).astype(np.int32), 2)
             for L in range(2, 3 + limit)]
    eng, got = _serve(tserve, model, params, specs, use_lilac=False,
                      compile_backend="aot_eager")
    prefills = [e for e in eng.compile_info()["by_entry"]
                if e["key"][0] == "prefill"]
    assert sorted(e["key"][1] for e in prefills) == list(range(2, 3 + limit))
    assert all(e["compiles"] == 1 and e["calls"] == 1 for e in prefills)
    _, eager = _serve(tserve, model, params, specs, use_lilac=False,
                      jit_prefill=False)
    assert got == eager


def test_jit_prefill_needs_a_model_with_tensors():
    class Mock:                 # the tests' integer mock has no tensors
        decode = prefill = None

    with pytest.raises(ValueError, match="jit_prefill"):
        tserve.Engine(Mock(), None, tserve.ServeConfig(use_lilac=False))


def test_jit_prefill_defaults_to_the_devices_backend_and_raises_on_a_break(
        small_lm):
    """Without ``compile_backend`` the engine's entries compile with
    ``jit.backend_for`` of its device (aot_eager on the CPU).  A prefill
    that breaks the graph raises (each entry is one graph), where the
    eager engine serves it."""
    _, _, model, params = small_lm
    prompt = np.arange(1, 6, dtype=np.int32)
    eng = tserve.Engine(model, params, tserve.ServeConfig(use_lilac=False))
    eng._prefill(prompt)
    assert [e["backend"] for e in eng.compile_info()["by_entry"]] \
        == [jit.backend_for("cpu")] == ["aot_eager"]

    class Breaking:
        """The smoke OLMoE with a graph break inside its prefill."""

        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, p, batch):
            torch._dynamo.graph_break()
            return model.prefill(p, batch)

    spec = [(prompt, 2)]
    with pytest.raises(torch._dynamo.exc.Unsupported):
        _serve(tserve, Breaking(), params, spec, use_lilac=False)
    _, got = _serve(tserve, Breaking(), params, spec, use_lilac=False,
                    jit_prefill=False)
    _, want = _serve(tserve, model, params, spec, use_lilac=False,
                     jit_prefill=False)
    assert got == want
