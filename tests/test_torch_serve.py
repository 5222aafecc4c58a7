"""The port's serving tier (``repro_torch.serve``) held against the JAX
package's (``repro.serve``): every case of ``tests/test_serve.py`` on the
port — bucket policy, scheduler invariants, continuous batching bit for
bit against solo decode over a mock model (seeded sweeps and
hypothesis), ragged MoE packing, the real model's engine against solo and
its prewarm — and the parity of the smoke OLMoE's serving path with the
reference on the reference's own parameters (``params_from_numpy``, cast
to f32 on both sides).

Tolerances: ``prefill`` logits and caches, and ``decode_step`` logits
and caches from the same cache on both sides (at a scalar and a per-slot
position), within 5e-5 of each leaf's largest magnitude.  The reference's
initialization gives the smoke model a residual stream of ~234 after one
MoE layer, so f32 rounding in either package reaches the next layer and
the logits amplified: the reference's own chunked attention (XLA on the
CPU) is 4.1e-6 from an f64 oracle where the port's is 8.3e-7, layer 1's
k/v then differ by 1.3e-5 and the logits by 1.3e-5 (prefill) and 1.7e-5
(one decode step), though each decode operator alone is within 1e-6 of
the f64 oracle in both packages.  The cache hooks: bit for bit.  ``moe_ffn_ragged`` against the
reference's (its Pallas kernel in interpret mode, as its tests run it):
within 1e-5.  The engines' greedy token streams, with and without lilac:
equal.

The mock model's decode is a per-slot integer rolling hash over
``(token, position)`` — the next token depends ONLY on that request's own
history, so any slot mix-up (wrong install row, bad eviction move, stale
position) changes the stream and fails the bit-identity property.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_arch as jget_arch, smoke_config as jsmoke
from repro.models.factory import build_model as jbuild_model
from repro import serve as jserve
from repro_torch import serve as tserve
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import faults
from repro_torch.core.harness import REGISTRY
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import build_model
from repro_torch.models.factory import params_from_numpy
from repro_torch.models.spec import leaves
from repro_torch.serve import (
    BucketError, BucketPolicy, Engine, Request, Scheduler, SchedulerFull,
    ServeConfig, SyntheticWorkload, build_engine, default_buckets,
    moe_ffn_padded, moe_ffn_ragged, pack, padding_waste, parse_buckets,
    unpack,
)

VOCAB = 10007
_MOD = 9973


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    # the port's stores in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE", "LILAC_TORCH_REQUEST_SHADOW_RATE",
              "LILAC_TORCH_SERVE_BUCKETS"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    REGISTRY.reset_autotuner()
    yield
    REGISTRY.reset_autotuner()


# ---------------------------------------------------------------------------
# mock model: integer rolling-hash decode, numpy-only (no accelerator)
# ---------------------------------------------------------------------------

def _fold(h: int, tok: int, pos: int) -> int:
    return (h * 1000003 + int(tok) * 31 + int(pos) + 7) % _MOD


class MockModel:
    """Model-surface stub for engine/scheduler tests.  The cache is
    ``{"state": (B,) int64, "cap": int}``; decode advances each row's
    hash with its (token, pos) pair and emits the hash as the next
    token."""

    def init_cache(self, B, S, device=None):
        return {"state": np.zeros((B,), np.int64), "cap": int(S)}

    def prefill(self, params, batch):
        toks = np.asarray(batch["tokens"])
        B, L = toks.shape
        h = np.zeros((B,), np.int64)
        for b in range(B):
            acc = 0
            for p in range(L):
                acc = _fold(acc, toks[b, p], p)
            h[b] = acc
        logits = np.zeros((B, VOCAB), np.float32)
        logits[np.arange(B), h] = 1.0
        return logits, {"state": h}

    def cache_from_prefill(self, caches, L, S):
        return {"state": np.asarray(caches["state"]).copy(),
                "cap": int(S)}

    def cache_set_slot(self, cache, slot, row):
        out = {"state": cache["state"].copy(), "cap": cache["cap"]}
        out["state"][slot] = row["state"][0]
        return out

    def cache_move_slot(self, cache, src, dst):
        out = {"state": cache["state"].copy(), "cap": cache["cap"]}
        out["state"][dst] = out["state"][src]
        return out

    def cache_resize(self, cache, B=None, max_seq=None):
        old = cache["state"]
        B = B if B is not None else old.shape[0]
        state = np.zeros((B,), np.int64)
        state[: min(B, old.shape[0])] = old[: min(B, old.shape[0])]
        return {"state": state,
                "cap": int(max_seq) if max_seq else cache["cap"]}

    def decode(self, params, cache, tokens, pos):
        tokens = np.asarray(tokens)
        pos = np.asarray(pos)
        B = tokens.shape[0]
        state = cache["state"].copy()
        for b in range(B):
            state[b] = _fold(int(state[b]), tokens[b, 0], int(pos[b]))
        logits = np.zeros((B, VOCAB), np.float32)
        logits[np.arange(B), state] = 1.0
        return logits, {"state": state, "cap": cache["cap"]}


def _mock_engine(mode="continuous", batch=(1, 2, 4), seq=(16, 32, 64),
                 **kw):
    cfg = ServeConfig(buckets=BucketPolicy(batch=batch, seq=seq),
                      mode=mode, use_lilac=False, jit_prefill=False,
                      **kw)
    return Engine(MockModel(), params=None, config=cfg)


def _solo_stream(prompt, max_new):
    """Reference stream computed directly from the hash recurrence."""
    h = 0
    for p, t in enumerate(prompt):
        h = _fold(h, t, p)
    out = [h]
    L = len(prompt)
    while len(out) < max_new:
        h = _fold(h, out[-1], L + len(out) - 1)
        out.append(h)
    return out


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

def test_bucket_smallest_fit_and_overflow():
    p = BucketPolicy(batch=(1, 2, 4), seq=(128, 512))
    assert p.batch_bucket(1) == 1
    assert p.batch_bucket(3) == 4
    assert p.seq_bucket(128) == 128
    assert p.seq_bucket(129) == 512
    with pytest.raises(BucketError):
        p.batch_bucket(5)
    with pytest.raises(BucketError):
        p.seq_bucket(513)
    assert p.max_batch == 4 and p.max_seq == 512
    assert len(p.grid()) == 6


def test_parse_buckets_and_env(monkeypatch):
    p = parse_buckets("1,2,4x128,256")
    assert p.batch == (1, 2, 4) and p.seq == (128, 256)
    monkeypatch.setenv("LILAC_TORCH_SERVE_BUCKETS", "2x64")
    assert default_buckets().spec() == "2x64"
    # the JAX package's variable does not reach the port
    monkeypatch.setenv("LILAC_SERVE_BUCKETS", "4x32")
    assert default_buckets().spec() == "2x64"
    monkeypatch.setenv("LILAC_TORCH_SERVE_BUCKETS", "nonsense")
    with pytest.raises(BucketError):
        default_buckets()


def test_bucket_policy_sorted_deduped():
    p = BucketPolicy(batch=(4, 1, 4), seq=(256, 64))
    assert p.batch == (1, 4) and p.seq == (64, 256)


# ---------------------------------------------------------------------------
# scheduler invariants + edge cases
# ---------------------------------------------------------------------------

def _req(plen=4, new=3, **kw):
    return Request(prompt=np.arange(1, plen + 1, dtype=np.int32),
                   max_new_tokens=new, **kw)


def test_scheduler_empty_batch_step():
    s = Scheduler(max_batch=4)
    assert s.idle
    assert s.admissions() == []
    assert s.evict_finished() == ([], [])


def test_scheduler_over_capacity_queue():
    s = Scheduler(max_batch=1, queue_capacity=2)
    s.submit(_req())
    s.submit(_req())
    with pytest.raises(SchedulerFull):
        s.submit(_req())
    assert s.queue_depth == 2


def test_scheduler_all_finish_same_step():
    s = Scheduler(max_batch=4)
    reqs = [_req(new=1) for _ in range(4)]
    for r in reqs:
        s.submit(r)
    assert s.admissions() == reqs
    for r in reqs:
        r.tokens.append(1)          # every request done at once
    finished, moves = s.evict_finished()
    assert finished == reqs and moves == [] and s.idle


def test_scheduler_static_waits_for_drain():
    s = Scheduler(max_batch=2, mode="static")
    a, b, c = _req(new=1), _req(new=2), _req(new=1)
    for r in (a, b, c):
        s.submit(r)
    assert s.admissions() == [a, b]
    a.tokens.append(1)
    s.evict_finished()
    assert s.admissions() == []     # b still running: no refill
    b.tokens += [1, 2]
    s.evict_finished()
    assert s.admissions() == [c]    # batch drained: next wave


def test_scheduler_compaction_moves_preserve_prefix():
    s = Scheduler(max_batch=6)
    reqs = [_req(new=5) for _ in range(6)]
    for r in reqs:
        s.submit(r)
    s.admissions()
    for i in (0, 2, 5):             # finish a head, a middle, and the tail
        reqs[i].tokens += [1] * 5
    finished, moves = s.evict_finished()
    assert {r.rid for r in finished} == {reqs[i].rid for i in (0, 2, 5)}
    # moves fill low holes from tail survivors, src >= n_new > dst
    n_new = 3
    assert all(src >= n_new > dst for src, dst in moves)
    assert s.active == [reqs[4], reqs[1], reqs[3]] or \
        {r.rid for r in s.active} == {reqs[i].rid for i in (1, 3, 4)}
    assert len(s.active) == n_new


def _drive_random_evictions(new_counts, rng):
    """Whatever subset finishes each step, survivors always end up in
    slots [0, n) and no move overwrites another move's source."""
    s = Scheduler(max_batch=8)
    reqs = [_req(new=n) for n in new_counts]
    for r in reqs:
        s.submit(r)
    while not s.idle:
        s.admissions()
        n = len(s.active)
        done = [i for i in range(n) if rng.random() < 0.4]
        before = {r.rid for r in s.active}
        for i in done:
            s.active[i].tokens += [1] * s.active[i].max_new_tokens
        survivors = [r.rid for r in s.active if not r.done]
        _, moves = s.evict_finished()
        seen_src = set()
        for src, dst in moves:
            assert src not in seen_src and dst < len(s.active)
            seen_src.add(src)
        assert sorted(r.rid for r in s.active) == sorted(survivors)
        assert all(r.rid in before for r in s.active)
        for r in s.active:          # undone requests must still make progress
            if not r.done:
                r.tokens.append(1)


def test_scheduler_random_evictions_seeded_sweep():
    for seed in range(25):
        rng = np.random.default_rng(seed)
        counts = list(rng.integers(1, 7, size=rng.integers(1, 11)))
        _drive_random_evictions(counts, rng)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 6), min_size=1, max_size=10),
       st.integers(0, 2**16))
def test_scheduler_random_evictions_keep_invariant(new_counts, seed):
    _drive_random_evictions(new_counts, np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# engine bit-identity: batched continuous == solo, over random workloads
# ---------------------------------------------------------------------------

def _make_requests(spec):
    out = []
    for plen, new, seed in spec:
        prompt = np.random.default_rng(seed).integers(
            1, VOCAB - 1, size=plen).astype(np.int32)
        out.append(Request(prompt=prompt, max_new_tokens=new))
    return out


def _check_bit_identity(spec, mode):
    eng = _mock_engine(mode=mode)
    reqs = _make_requests(spec)
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    for (plen, new, _), r in zip(spec, reqs):
        assert len(r.tokens) == new
        assert r.tokens == _solo_stream(list(r.prompt), new), \
            f"stream diverged for rid={r.rid} mode={mode}"


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_batched_streams_bit_identical_seeded_sweep(mode):
    for seed in range(12):
        rng = np.random.default_rng((77, seed))
        spec = [(int(rng.integers(1, 11)), int(rng.integers(1, 7)),
                 int(rng.integers(0, 2**16)))
                for _ in range(int(rng.integers(1, 9)))]
        _check_bit_identity(spec, mode)


@st.composite
def request_set(draw):
    n = draw(st.integers(1, 8))
    return [(draw(st.integers(1, 10)), draw(st.integers(1, 6)),
             draw(st.integers(0, 2**16))) for _ in range(n)]


@settings(max_examples=30, deadline=None)
@given(request_set(), st.sampled_from(["continuous", "static"]))
def test_batched_streams_bit_identical_to_solo(spec, mode):
    _check_bit_identity(spec, mode)


def test_engine_eviction_midstream_does_not_corrupt_neighbors():
    """A short request finishing early triggers a compaction move; the
    surviving long request's stream must be unaffected."""
    eng = _mock_engine(batch=(2,), seq=(32,))
    short = _req(plen=3, new=1)
    long = _req(plen=5, new=8)
    late = _req(plen=4, new=2)      # admitted into the freed slot
    for r in (short, long, late):
        assert eng.submit(r)
    eng.run_until_idle()
    assert long.tokens == _solo_stream(list(long.prompt), 8)
    assert late.tokens == _solo_stream(list(late.prompt), 2)


def test_engine_rejects_unbucketable_and_full_queue():
    eng = _mock_engine(batch=(1,), seq=(16,), queue_capacity=1)
    assert not eng.submit(_req(plen=20, new=4))      # 24 > max seq 16
    assert eng.metrics.snapshot()["requests"]["rejected"] == 1
    assert eng.submit(_req(plen=2, new=2))           # fills the 1-deep queue
    assert not eng.submit(_req(plen=2, new=2))       # queue full
    assert eng.metrics.snapshot()["requests"]["rejected"] == 2
    eng.step()                                       # admits, queue drains
    assert eng.submit(_req(plen=2, new=2))
    eng.run_until_idle()


def test_engine_eos_stops_stream():
    eng = _mock_engine()
    r = _req(plen=4, new=50)
    stream = _solo_stream(list(r.prompt), 50)
    r.eos_id = stream[2]            # third token is "eos"
    assert eng.submit(r)
    eng.run_until_idle()
    assert r.tokens == stream[:3]


def test_engine_run_with_workload_snapshot():
    wl = SyntheticWorkload(n_requests=5, vocab=VOCAB, prompt_len=(2, 6),
                           new_tokens=(1, 4), seed=3)
    eng = _mock_engine()
    snap = eng.run(wl)
    assert snap["requests"]["finished"] == 5
    assert snap["requests"]["rejected"] == 0
    assert snap["steps"] >= 1
    assert 0.0 < snap["batch_occupancy"] <= 1.0
    assert np.isfinite(snap["ttft_s"]["p99"])


def test_workload_deterministic_replay():
    wl = SyntheticWorkload(n_requests=4, vocab=100, seed=9)
    a, b = wl.requests(), wl.requests()
    for (ta, ra), (tb, rb) in zip(a, b):
        assert ta == tb
        assert np.array_equal(ra.prompt, rb.prompt)
        assert ra.max_new_tokens == rb.max_new_tokens


def test_workload_matches_the_reference():
    """The same (seed, index) draws the same traffic in both packages."""
    kw = dict(n_requests=6, vocab=300, seed=5, rate_rps=4.0)
    for (ta, ra), (tb, rb) in zip(SyntheticWorkload(**kw).requests(),
                                  jserve.SyntheticWorkload(**kw).requests()):
        assert ta == tb and ra.max_new_tokens == rb.max_new_tokens
        assert np.array_equal(ra.prompt, rb.prompt)


# ---------------------------------------------------------------------------
# ragged packing
# ---------------------------------------------------------------------------

def _check_pack_roundtrip(parts):
    arrs = [torch.tensor(p, dtype=torch.float32).reshape(-1, 1)
            for p in parts]
    flat, offsets = pack(arrs)
    assert offsets[0] == 0 and offsets[-1] == sum(len(p) for p in parts)
    back = unpack(flat, offsets)
    assert len(back) == len(parts)
    for a, b in zip(arrs, back):
        assert torch.equal(a, b)


def test_pack_unpack_roundtrip_seeded_sweep():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        parts = [list(rng.integers(-5, 6, size=rng.integers(0, 8)))
                 for _ in range(rng.integers(1, 7))]
        _check_pack_roundtrip(parts)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.lists(st.integers(-5, 5), min_size=0, max_size=7),
                min_size=1, max_size=6))
def test_pack_unpack_roundtrip(parts):
    _check_pack_roundtrip(parts)


def test_padding_waste():
    assert padding_waste([4, 4]) == 0.0
    assert padding_waste([1, 3], pad_to=4) == pytest.approx(0.5)


def _ragged_inputs(lengths, E=4, D=8, F=16, K=2, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((t, D)).astype(np.float32) for t in lengths]
    gates = [rng.random((t, K)).astype(np.float32) for t in lengths]
    idxs = [rng.integers(0, E, (t, K)).astype(np.int32) for t in lengths]
    wg, wu = (rng.standard_normal((E, D, F)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((E, F, D)).astype(np.float32) * 0.1
    return xs, gates, idxs, wg, wu, wd


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_ragged_moe_matches_padded():
    xs, gates, idxs, wg, wu, wd = _ragged_inputs([3, 7, 1, 5])
    w = _t([wg, wu, wd])
    ragged = moe_ffn_ragged(_t(xs), _t(gates), _t(idxs), *w,
                            backend="naive")
    padded = moe_ffn_padded(_t(xs), _t(gates), _t(idxs), *w)
    for a, b in zip(ragged, padded):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("lengths", [[3, 7, 1, 5], [1, 1], [12]])
def test_ragged_moe_matches_the_reference(lengths):
    """The grouped matmul's path (K4's plain version on the CPU) against
    the reference's Pallas kernel in interpret mode, per request."""
    xs, gates, idxs, wg, wu, wd = _ragged_inputs(lengths, seed=len(lengths))
    got = moe_ffn_ragged(_t(xs), _t(gates), _t(idxs), *_t([wg, wu, wd]))
    want = jserve.moe_ffn_ragged(
        [jnp.asarray(a) for a in xs], [jnp.asarray(a) for a in gates],
        [jnp.asarray(a) for a in idxs], jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), interpret=True)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the smoke OLMoE against the JAX package on the reference's parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_lm():
    """(reference model, its f32 params, port model, the same params)."""
    jcfg = jsmoke(jget_arch("olmoe-1b-7b")).replace(
        moe_decode_impl="naive_flat")
    jmodel = jbuild_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init(jax.random.PRNGKey(0)))
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(
        moe_decode_impl="naive_flat")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _np_cache(tree):
    return {k: _np_cache(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_prefill_matches_the_reference(small_lm):
    jmodel, jparams, model, params = small_lm
    toks = np.random.default_rng(2).integers(1, 256, (2, 7)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, 5e-5)
    jflat, tflat = dict(leaves(_np_cache(jc))), dict(leaves(tc))
    assert jflat.keys() == tflat.keys()
    for k, a in jflat.items():
        assert tuple(tflat[k].shape) == a.shape, k
        _close(tflat[k].numpy(), a, 5e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_the_reference(small_lm, per_slot):
    """One decode step from the same cache (the reference's prefill,
    carried across): logits and every new cache leaf."""
    jmodel, jparams, model, params = small_lm
    rng = np.random.default_rng(3)
    B, L, S = 2, 5, 16
    toks = rng.integers(1, 256, (B, L)).astype(np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    jcache = jmodel.cache_from_prefill(jc, L, S)
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    step = rng.integers(1, 256, (B, 1)).astype(np.int32)
    pos = np.array([L, L - 2], np.int32) if per_slot else np.int32(L)
    jlo, jnc = jmodel.decode(jparams, jcache, jnp.asarray(step),
                             jnp.asarray(pos))
    tlo, tnc = model.decode(params, tcache, torch.from_numpy(step),
                            torch.as_tensor(pos))
    _close(tlo.numpy(), jlo, 5e-5)
    jflat, tflat = dict(leaves(_np_cache(jnc))), dict(leaves(tnc))
    assert jflat.keys() == tflat.keys()
    for k, a in jflat.items():
        _close(tflat[k].numpy(), a, 5e-5)


def test_cache_hooks_match_the_reference_bit_for_bit(small_lm):
    """cache_from_prefill, cache_set_slot, cache_move_slot and
    cache_resize (growth and shrink) on the same caches."""
    jmodel, jparams, model, params = small_lm
    toks = np.random.default_rng(4).integers(1, 256, (1, 6)).astype(np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)

    def same(jtree, ttree):
        jflat, tflat = dict(leaves(_np_cache(jtree))), dict(leaves(ttree))
        assert jflat.keys() == tflat.keys()
        for k, a in jflat.items():
            assert tuple(tflat[k].shape) == a.shape, k
            assert tflat[k].is_contiguous(), k
            np.testing.assert_array_equal(tflat[k].numpy(), a, err_msg=k)

    jrow, trow = jmodel.cache_from_prefill(jc, 6, 16), \
        model.cache_from_prefill(tc, 6, 16)
    same(jrow, trow)
    jb = jmodel.cache_set_slot(jmodel.init_cache(3, 16), 2, jrow)
    tb = model.cache_set_slot(model.init_cache(3, 16), 2, trow)
    same(jb, tb)
    jb, tb = jmodel.cache_move_slot(jb, 2, 0), model.cache_move_slot(tb, 2, 0)
    same(jb, tb)
    for B, S in ((4, 32), (1, 8), (2, 16)):
        jb = jmodel.cache_resize(jb, B=B, max_seq=S)
        tb = model.cache_resize(tb, B=B, max_seq=S)
        same(jb, tb)


def _engine_requests(vocab):
    """The reference test's requests (tests/test_serve.py, seed 1)."""
    rng = np.random.default_rng(1)
    return [(rng.integers(1, vocab, size=p).astype(np.int32), n)
            for p, n in ((5, 4), (3, 6), (7, 3))]


@pytest.mark.parametrize("use_lilac", [False, True])
def test_engine_streams_match_the_reference_engine(small_lm, use_lilac):
    jmodel, jparams, model, params = small_lm
    specs = _engine_requests(256)

    def run(serve, m, p):
        eng = serve.Engine(m, p, serve.ServeConfig(
            buckets=serve.BucketPolicy(batch=(1, 2), seq=(16,)),
            use_lilac=use_lilac, prewarm_on_start=False, jit_prefill=False))
        reqs = [serve.Request(prompt=pr, max_new_tokens=n)
                for pr, n in specs]
        for r in reqs:
            assert eng.submit(r)
        eng.run_until_idle()
        return eng, [list(r.tokens) for r in reqs]

    eng, got = run(tserve, model, params)
    _, want = run(jserve, jmodel, jparams)
    assert got == want
    if use_lilac:      # the port's decode runs its MoE layers as matches
        assert [m.computation for m, _ in eng._decode.last_selections] \
            == ["moe_ffn", "moe_ffn"]


def test_real_model_engine_matches_solo(small_lm):
    _, _, model, params = small_lm
    policy = BucketPolicy(batch=(1, 2), seq=(16,))
    eng = Engine(model, params,
                 ServeConfig(buckets=policy, use_lilac=False,
                             jit_prefill=False, prewarm_on_start=False))
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(1, 256, size=p)
                    .astype(np.int32), max_new_tokens=n)
            for p, n in ((5, 4), (3, 6), (7, 3))]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        solo = eng.generate_solo(r.prompt, r.max_new_tokens)
        assert r.tokens == solo, f"batched != solo for rid={r.rid}"
        assert eng.replay_solo(r) == r.tokens


def test_real_model_prewarm_bakes_grid(small_lm):
    _, _, model, params = small_lm
    policy = BucketPolicy(batch=(1, 2), seq=(16,))
    eng = Engine(model, params, ServeConfig(buckets=policy,
                                            jit_prefill=False))
    pw = eng.metrics.prewarm
    assert pw["n_signatures"] == len(policy.grid())
    assert pw["baked"] == len(policy.grid())
    assert pw["detect_calls"] == len(policy.grid())
    r = Request(prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=3)
    assert eng.submit(r)
    eng.run_until_idle()
    assert len(r.tokens) == 3
    snap = eng.metrics.snapshot()
    assert snap["buckets"]["misses"] == 0    # every decode on a warm bucket
    assert eng._decode.stats["detects"] == len(policy.grid())
    assert eng._decode.plan_info()["plan_hits"] >= 2
    # a second replica on the shared plan cache detects nothing
    eng2 = Engine(model, params, ServeConfig(buckets=policy,
                                             jit_prefill=False))
    assert eng2.metrics.prewarm["detect_calls"] == 0
    assert eng2.metrics.prewarm["baked"] == len(policy.grid())


def test_vector_pos_decode_matches_scalar(small_lm):
    """attention_decode_stacked with a (B,)-vector of equal positions is
    byte-identical to the scalar-pos path."""
    _, _, model, params = small_lm
    B, L, S = 2, 5, 16
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, 256, (B, L)).astype(np.int32))
    _, caches = model.prefill(params, {"tokens": toks})
    cache = model.cache_from_prefill(caches, L, S)
    step = torch.from_numpy(rng.integers(1, 256, (B, 1)).astype(np.int32))
    lo_s, c_s = model.decode(params, cache, step,
                             torch.tensor(L, dtype=torch.int32))
    lo_v, c_v = model.decode(params, cache, step,
                             torch.full((B,), L, dtype=torch.int32))
    assert torch.equal(lo_s, lo_v)
    for (_, a), (_, b) in zip(leaves(c_s), leaves(c_v)):
        assert torch.equal(a, b)


def test_build_engine_runs_on_the_card_unless_asked(monkeypatch):
    """No CPU path when no card is found: the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("olmoe-1b-7b")
    eng = build_engine("olmoe-1b-7b", device="cpu",
                       config=ServeConfig(prewarm_on_start=False))
    assert eng.device.type == "cpu"
