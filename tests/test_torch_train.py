"""Training through the port, held against the JAX package on the same
seeded inputs: the checkpointer (the single-device tests of
``tests/test_checkpoint.py``), AdamW against the reference's
``adamw_update``, the data pipeline bit for bit, the smoke-size OLMoE and
OLMo models' loss and gradients on the reference's own parameters
(``params_from_numpy``), one ``make_train_step`` step against the
reference's, the ``lilac_grad=True`` step against the plain one, and a
restart that repeats the uninterrupted run's losses exactly.

Tolerances: the models' loss within 1e-4 relative and every gradient leaf
within relative L2 1e-4 (f32 on both sides, the reference's bf16
parameters cast to f32 for both); AdamW 1e-6; one train step's loss and
gradient norm within 1e-4 relative and its update (new minus old
parameters) within relative L2 5e-3 — Adam's first step is lr·g/(|g| +
eps), so an entry whose gradient is ~0 moves by a sign that rounding
decides (13 of 165,184 entries differ by more than 1e-5 here).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.train import data as jdata
from repro.train import optim as JO
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import lilac
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import build_model
from repro_torch.models.factory import params_from_numpy
from repro_torch.models.spec import leaves
from repro_torch.train import optim as O
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import (MemmapCorpus, SyntheticEmbeds,
                                    SyntheticLM, write_corpus)
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.train_step import make_train_step, value_and_grad

SEQ, BATCH = 32, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
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


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
        "b": {"scale": torch.from_numpy(
                  rng.standard_normal(16).astype(np.float32)),
              "step": torch.tensor(3, dtype=torch.int32)},
        "h": torch.from_numpy(rng.standard_normal(4).astype(np.float32))
        .to(torch.bfloat16),
    }


def _flat(tree):
    return dict(leaves(tree))


# ---------------------------------------------------------------------------
# checkpoints, data, stragglers (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(10, t, blocking=True)
    assert ck.latest_step() == 10
    out = ck.restore(10, {"w": torch.zeros(8, 16),
                          "b": {"scale": torch.zeros(16),
                                "step": torch.tensor(0, dtype=torch.int32)},
                          "h": torch.zeros(4, dtype=torch.bfloat16)})
    for k, a in _flat(t).items():
        b = _flat(out)[k]
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    ck.wait()
    assert ck.available_steps() == [3, 4]


def test_atomic_no_partial_checkpoint(tmp_path):
    """A .tmp dir (crashed writer) is never listed as restorable."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_6.tmp")
    (tmp_path / "step_6.tmp" / "junk.npy").write_bytes(b"xx")
    assert ck.available_steps() == [5]


def test_restore_takes_the_templates_dtype_and_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(6.0).reshape(2, 3)}, blocking=True)
    out = ck.restore(1, {"w": torch.zeros(2, 3, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3).double())


def test_checkpoint_files_are_the_references(tmp_path):
    """The port's checkpoint of a tree reads back with numpy as the
    reference's does (bf16 as its 16-bit pattern)."""
    Checkpointer(str(tmp_path / "t")).save(1, _tree(), blocking=True)
    jt = {"w": jnp.asarray(_tree()["w"].numpy()),
          "b": {"scale": jnp.asarray(_tree()["b"]["scale"].numpy()),
                "step": jnp.asarray(3, jnp.int32)}}
    from repro.train.checkpoint import Checkpointer as JCheckpointer
    JCheckpointer(str(tmp_path / "j")).save(1, jt, blocking=True)
    for name in ("w", "b__scale", "b__step"):
        a = np.load(tmp_path / "t" / "step_1" / f"{name}.npy")
        b = np.load(tmp_path / "j" / "step_1" / f"{name}.npy")
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 123), (3, 5)])
def test_synthetic_lm_batches_are_the_references(seed, step):
    got = SyntheticLM(vocab=100, seq_len=16, global_batch=4,
                      seed=seed).batch_at(step)
    want = jdata.SyntheticLM(vocab=100, seq_len=16, global_batch=4,
                             seed=seed).batch_at(step)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_embeds_and_memmap_batches_are_the_references(tmp_path):
    got = SyntheticEmbeds(8, 50, 6, 3, seed=2).batch_at(4)
    want = jdata.SyntheticEmbeds(8, 50, 6, 3, seed=2).batch_at(4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    path = str(tmp_path / "corpus.bin")
    write_corpus(path, np.arange(1000) % 97)
    got = MemmapCorpus(path, 16, 4, seed=1).batch_at(9)
    want = jdata.MemmapCorpus(path, 16, 4, seed=1, process_index=0,
                              process_count=1).batch_at(9)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_pure_function_of_step():
    d1 = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=7)
    d2 = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=7)
    np.testing.assert_array_equal(d1.batch_at(123)["tokens"],
                                  d2.batch_at(123)["tokens"])
    assert not np.array_equal(d1.batch_at(124)["tokens"],
                              d1.batch_at(123)["tokens"])


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    events = []
    mon.on_straggler = lambda s, t, e: events.append(s)
    for s in range(10):
        mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)          # 10x the EWMA -> straggler
    assert events == [10]
    assert not mon.observe(11, 0.1)      # EWMA not poisoned by the outlier


def test_train_restart_resumes(tmp_path):
    cfg = smoke_config(get_arch("olmo-1b"))
    model = build_model(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2)
    lc = LoopConfig(steps=6, ckpt_every=3, log_every=100,
                    ckpt_dir=str(tmp_path))
    train_loop(model, O.AdamWConfig(total_steps=10), lc, data.batch_at,
               device="cpu", backend="aot_eager", emit=lambda s: None)
    lc2 = LoopConfig(steps=8, ckpt_every=100, log_every=100,
                     ckpt_dir=str(tmp_path))
    r2 = train_loop(model, O.AdamWConfig(total_steps=10), lc2, data.batch_at,
                    device="cpu", backend="aot_eager", emit=lambda s: None)
    assert len(r2["history"]) == 2      # resumed at 6, ran 6..8


def test_restart_repeats_the_uninterrupted_losses_bit_for_bit(tmp_path):
    """Four steps with a checkpoint every two, then a restart from step 2
    run to 4: the resumed losses are the uninterrupted run's exactly."""
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_impl="lilac")
    model = build_model(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    opt = O.AdamWConfig(**OPT)
    lc = LoopConfig(steps=4, ckpt_every=2, log_every=100,
                    ckpt_dir=str(tmp_path), deterministic=True)
    r1 = train_loop(model, opt, lc, data.batch_at, device="cpu",
                    backend="aot_eager", emit=lambda s: None)
    ck = Checkpointer(str(tmp_path))
    assert ck.available_steps() == [2, 4]
    import shutil
    shutil.rmtree(tmp_path / "step_4")
    r2 = train_loop(model, opt, lc, data.batch_at, device="cpu",
                    backend="aot_eager", emit=lambda s: None)
    assert r2["start_step"] == 2
    assert r2["history"] == r1["history"][2:]
    for k, a in _flat(r1["params"]).items():
        assert torch.equal(a, _flat(r2["params"])[k]), k


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_reference(compress):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": {"c": (300,), "d": (3,)}}

    def draw(tree, scale=1.0):
        return {k: draw(v, scale) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}

    params = draw(shapes)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5,
               compress_grads=compress)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"]),
          "b": {k: torch.from_numpy(v) for k, v in params["b"].items()}}
    jst, tst = JO.adamw_init(JO.AdamWConfig(**cfg), jp), \
        O.adamw_init(O.AdamWConfig(**cfg), tp)
    for _ in range(3):
        g = draw(shapes, 3.0)
        jp, jst, jm = JO.adamw_update(JO.AdamWConfig(**cfg),
                                      jax.tree.map(jnp.asarray, g), jst, jp)
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {k: torch.from_numpy(v) for k, v in g["b"].items()}}
        tp, tst, tm = O.adamw_update(O.AdamWConfig(**cfg), tg, tst, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    for (path, a) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(_flat(tp)[name].numpy(), np.asarray(a),
                                   atol=1e-6, rtol=1e-6)
    if compress:
        for (path, a) in jax.tree_util.tree_flatten_with_path(jst["err"])[0]:
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            np.testing.assert_allclose(_flat(tst["err"])[name].numpy(),
                                       np.asarray(a), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the models and the train step against the reference
# ---------------------------------------------------------------------------

def _reference(arch, moe_impl=None):
    jcfg = jsmoke(jget_arch(arch))
    cfg = smoke_config(get_arch(arch))
    if moe_impl:
        jcfg, cfg = jcfg.replace(moe_impl=moe_impl), cfg.replace(
            moe_impl=moe_impl)
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                        seed=1).batch_at(0)
    return (jm, jp, {k: jnp.asarray(v) for k, v in batch.items()}), \
        (tm, params_from_numpy(cfg, jax.tree.map(np.asarray, jp)),
         {k: torch.from_numpy(v) for k, v in batch.items()})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("arch,moe_impl", [("olmoe-1b-7b", "grouped"),
                                           ("olmoe-1b-7b", "naive"),
                                           ("olmo-1b", None)])
def test_smoke_model_loss_and_grads_match_reference(arch, moe_impl):
    (jm, jp, jb), (tm, tp, tb) = _reference(arch, moe_impl)
    assert tm.param_count() == jm.param_count()
    assert tm.active_param_count() == jm.active_param_count()
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tl, tg = value_and_grad(tm.loss_fn)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    flat = _flat(tg)
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        assert _rel_l2(flat[name].numpy(), g) < 1e-4, name


def test_params_from_numpy_checks_shapes():
    cfg = smoke_config(get_arch("olmo-1b"))
    jp = jbuild_model(jsmoke(jget_arch("olmo-1b"))).init(jax.random.key(1))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    assert tp["embed"].dtype == torch.bfloat16          # the reference's
    jp["unembed"] = jp["unembed"][:, :3]
    with pytest.raises(ValueError, match="spec has"):
        params_from_numpy(cfg, jax.tree.map(np.asarray, jp))


def test_train_step_matches_reference():
    (jm, jp, jb), (tm, tp, tb) = _reference("olmoe-1b-7b")
    jstep = jax.jit(jmake_train_step(jm, JO.AdamWConfig(**OPT)))
    jnew, _, jmet = jstep(jp, JO.adamw_init(JO.AdamWConfig(**OPT), jp), jb)
    step = make_train_step(tm, O.AdamWConfig(**OPT))
    tnew, tst, tmet = step(tp, O.adamw_init(O.AdamWConfig(**OPT), tp), tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    old, new = _flat(tp), _flat(tnew)
    num = den = 0.0
    for path, a in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        p0 = old[name].double().numpy()
        dj = np.asarray(a, np.float64) - p0
        dt = new[name].double().numpy() - p0
        num += float(((dj - dt) ** 2).sum())
        den += float((dj ** 2).sum())
    assert np.sqrt(num / den) < 5e-3


def test_lilac_grad_step_equals_the_plain_step():
    """``lilac_grad=True``: ``torch.func.grad_and_value(loss_fn)`` through
    ``lilac.compile`` (the MoE of each sequence compiled inside it) gives
    the plain step's parameters."""
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_impl="lilac")
    model = build_model(cfg)
    (_, _, _), (_, tp, tb) = _reference("olmoe-1b-7b")
    opt = O.AdamWConfig(**OPT)
    plain = make_train_step(model, opt)
    fast = make_train_step(model, opt, lilac_grad=True,
                           lilac_options={"platform": "cpu"})
    pa, _, ma = plain(tp, O.adamw_init(opt, tp), tb)
    pb, _, mb = fast(tp, O.adamw_init(opt, tp), tb)
    np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                               rtol=1e-6)
    a, b = _flat(pa), _flat(pb)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_value_and_grad_names_a_parameter_without_gradient():
    """A floating leaf the loss does not reach raises, naming it: never a
    silent zero gradient (a harness that lost autograd history)."""
    params = {"used": torch.ones(3), "moe": {"wg": torch.ones(2)},
              "step": torch.zeros((), dtype=torch.int32)}
    loss, grads = value_and_grad(
        lambda p, b: (p["used"] * b).sum() + p["moe"]["wg"].sum())(
        params, torch.arange(3.0))
    assert float(loss) == 5.0 and grads["step"].dtype == torch.int32
    with pytest.raises(ValueError, match=r"\['moe'\]\['wg'\]"):
        value_and_grad(lambda p, b: (p["used"] * b).sum())(
            params, torch.arange(3.0))


@pytest.mark.parametrize("policy", [None, "cuda.gmm"])
def test_lilac_moe_gradients_equal_the_naive_models(policy, monkeypatch):
    """The smoke OLMoE's loss and every gradient leaf with
    ``moe_impl="lilac"`` against ``moe_impl="naive"`` from the same
    parameters and batch, at relative L2 1e-5 (f32).  Top-4 of 8 experts
    puts the ``torch.capacity`` harness's capacity at the sequence length,
    so no pair drops in the default selection; ``cuda.gmm`` (its plain
    version on the CPU) runs its ``vjp`` clause, ``moe_ffn_bwd``."""
    import repro_torch.models.layers as L

    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_topk=4)
    (_, _, _), (_, tp, tb) = _reference("olmoe-1b-7b")
    inner = lilac.compile(L._moe_naive_2d, platform="cpu",
                          **({"policy": policy} if policy else {}))
    monkeypatch.setitem(L._LILAC_MOE, "cpu", inner)
    lg, gl = value_and_grad(build_model(cfg.replace(moe_impl="lilac"))
                            .loss_fn)(tp, tb)
    ln, gn = value_and_grad(build_model(cfg.replace(moe_impl="naive"))
                            .loss_fn)(tp, tb)
    assert [n for _, n in inner.last_selections] == [policy
                                                     or "torch.capacity"]
    np.testing.assert_allclose(float(lg), float(ln), rtol=1e-6)
    flat = _flat(gn)
    for k, g in _flat(gl).items():
        assert float(flat[k].abs().max()) > 0, k
        assert _rel_l2(g.numpy(), flat[k].numpy()) < 1e-5, k


def test_microbatches_accumulate_the_full_batch_gradient():
    cfg = smoke_config(get_arch("olmo-1b"))
    (_, _, _), (_, tp, tb) = _reference("olmo-1b")
    opt = O.AdamWConfig(**OPT)
    one = make_train_step(build_model(cfg), opt)
    two = make_train_step(build_model(cfg.replace(microbatches=2)), opt)
    _, _, m1 = one(tp, O.adamw_init(opt, tp), tb)
    _, _, m2 = two(tp, O.adamw_init(opt, tp), tb)
    # the loss is a token mean per microbatch: equal halves of the batch
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-2)


def test_remat_gives_the_same_loss_and_gradients():
    """``cfg.remat`` runs each period under torch.utils.checkpoint: the
    backward replays the period's forward, with the same values."""
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_impl="lilac")
    (_, _, _), (_, tp, tb) = _reference("olmoe-1b-7b")
    l0, g0 = value_and_grad(build_model(cfg).loss_fn)(tp, tb)
    l1, g1 = value_and_grad(build_model(cfg.replace(remat=True)).loss_fn)(
        tp, tb)
    assert float(l1) == float(l0)
    for k, a in _flat(g0).items():
        torch.testing.assert_close(_flat(g1)[k], a, atol=1e-6, rtol=1e-5)


def test_launcher_and_examples_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    import sys

    from repro_torch.examples import train_sparse_moe
    from repro_torch.launch import train as launch

    argv = ["train", "--arch", "olmoe-1b-7b", "--smoke", "--steps", "2",
            "--seq", "16", "--batch", "2", "--moe-impl", "lilac",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    monkeypatch.setattr(sys, "argv", argv)
    launch.main()
    launch.main()                       # resumes from the last checkpoint
    out = capsys.readouterr().out
    assert "[restart] restored checkpoint step 2" in out and "final:" in out
    monkeypatch.setattr(sys, "argv", ["x", "--steps", "2", "--device", "cpu"])
    train_sparse_moe.main()
    out = capsys.readouterr().out
    assert "moe_ffn/MOE" in out and "after one step: 0.00e+00" in out
    assert "baked=1 plan_hits=2" in out
