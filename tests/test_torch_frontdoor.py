"""The port's front door and serving resilience: every case of
``tests/test_frontdoor.py`` (hashed routing, replica-crash failover with
zero silent drops, telemetry-driven health checks, request-level shadow
verification, the adaptive shadow-rate controller, cross-replica
quarantine sharing) and the six serving cases of
``tests/test_resilience.py`` (bounded admission retry, decode faults that
evict only the poisoned request, deadlines, the serving chaos property),
on ``repro_torch.serve`` and the port's fault sites (``decode_raise``,
``decode_nan``, ``replica_crash``, ``shadow_diverge:request``) with its
own variables (``LILAC_TORCH_SERVE_REPLICAS``,
``LILAC_TORCH_SHADOW_*``).

All fleet mechanics run on the mock rolling-hash model of
``test_torch_serve`` — the streams are deterministic, so "the survivor
regenerates the identical tokens" is checked exactly, with no
accelerator in the loop; the last cases run the smoke OLMoE's compiled
engine under the request shadow and on a two-replica fleet.
"""
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import faults
from repro_torch.core import resilience as R
from repro_torch.models import build_model
from repro_torch.models.spec import tree_map
from repro_torch.serve import (BucketPolicy, Engine, FrontDoor, Request,
                               Scheduler, ServeConfig, build_fleet,
                               default_replicas)

from test_torch_serve import MockModel, _mock_engine, _own_store, \
    _solo_stream  # noqa: F401  (_own_store: the autouse fixture)


def _mock_fleet(n=3, *, fault_streak=8, request_shadow_rate=None, **kw):
    cfg = ServeConfig(buckets=BucketPolicy(batch=(1, 2, 4), seq=(32, 64)),
                      use_lilac=False, jit_prefill=False,
                      request_shadow_rate=request_shadow_rate, **kw)
    engines = [Engine(MockModel(), params=None, config=cfg)
               for _ in range(n)]
    return FrontDoor(engines, fault_streak=fault_streak)


def _req(prompt, max_new):
    return Request(prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=max_new)


def _submit_many(fd, n, max_new=6, plen=5, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        r = _req(rng.integers(1, 9000, size=plen), max_new)
        assert fd.submit(r)
        reqs.append(r)
    return reqs


# ---------------------------------------------------------------------------
# routing + steady state
# ---------------------------------------------------------------------------

def test_frontdoor_routes_and_streams_match_solo():
    fd = _mock_fleet(3)
    reqs = _submit_many(fd, 12)
    used = {fd.assignment[r.rid] for r in reqs}
    assert len(used) > 1                      # hashing actually spreads load
    fd.run_until_idle()
    assert fd.accounted()
    for r in reqs:
        assert r.failed is None
        assert r.tokens == _solo_stream(list(r.prompt), r.max_new_tokens)
    snap = fd.snapshot()
    assert snap["fleet"]["finished"] == 12
    assert snap["fleet"]["failovers"] == 0
    assert snap["fleet"]["all_requests_accounted_for"]


def test_default_replicas_env(monkeypatch):
    monkeypatch.delenv("LILAC_TORCH_SERVE_REPLICAS", raising=False)
    monkeypatch.setenv("LILAC_SERVE_REPLICAS", "7")   # the JAX package's
    assert default_replicas() == 2
    monkeypatch.setenv("LILAC_TORCH_SERVE_REPLICAS", "5")
    assert default_replicas() == 5
    monkeypatch.setenv("LILAC_TORCH_SERVE_REPLICAS", "junk")
    assert default_replicas() == 2


# ---------------------------------------------------------------------------
# replica_crash failover
# ---------------------------------------------------------------------------

def test_replica_crash_redistributes_without_loss():
    """Killing 1 of 3 replicas mid-run loses zero requests: drained work
    is replayed on survivors and every stream stays bit-identical to the
    solo reference."""
    fd = _mock_fleet(3)
    reqs = _submit_many(fd, 15, max_new=8)
    victim = fd.assignment[reqs[0].rid]
    for _ in range(2):                    # mid-burst: some tokens exist
        fd.step()
    with faults.inject(f"replica_crash:replica{victim}") as plan:
        fd.step()
    assert plan.fired and plan.fired[0][0] == "replica_crash"
    assert not fd.replicas[victim].healthy
    assert "crash" in fd.replicas[victim].reason
    fd.run_until_idle()
    assert fd.accounted()
    assert fd.failovers == 1
    assert fd.redistributed > 0
    assert fd.lost == 0
    for r in reqs:
        assert r.failed is None
        assert r.tokens == _solo_stream(list(r.prompt), r.max_new_tokens)
    snap = fd.snapshot()
    assert snap["fleet"]["healthy"] == 2
    assert snap["fleet"]["redistributed"] == fd.redistributed


def test_all_replicas_lost_fails_loudly():
    fd = _mock_fleet(2)
    reqs = _submit_many(fd, 6)
    with faults.inject("replica_crash"):      # every site: whole fleet dies
        fd.step()
    assert not fd.healthy_replicas()
    assert fd.accounted()                     # failed loudly, not dropped
    for r in reqs:
        assert r.failed == "replica_lost"
        assert r.finish_t is not None
    snap = fd.snapshot()
    assert snap["fleet"]["replica_lost"] == 6
    assert snap["fleet"]["failed_reasons"] == {"replica_lost": 6}


def test_past_deadline_request_lost_at_failover():
    t = [0.0]
    cfg = ServeConfig(buckets=BucketPolicy(batch=(1, 2), seq=(32,)),
                      use_lilac=False, jit_prefill=False)
    engines = [Engine(MockModel(), params=None, config=cfg,
                      clock=lambda: t[0]) for _ in range(2)]
    fd = FrontDoor(engines, clock=lambda: t[0])
    fresh = _req([1, 2, 3], 4)
    stale = _req([4, 5, 6], 4)
    stale.deadline_s = 0.5
    assert fd.submit(fresh) and fd.submit(stale)
    victim = fd.assignment[stale.rid]
    t[0] = 1.0                              # stale is now past its deadline
    with faults.inject(f"replica_crash:replica{victim}"):
        fd.step()
    assert stale.failed == "replica_lost"   # loud, attributed — not retried
    fd.run_until_idle()
    assert fd.accounted()
    if fd.assignment[fresh.rid] != victim or fresh.done:
        assert fresh.failed is None


def test_health_check_retires_fault_streak_replica():
    """A replica whose every step burns a decode fault is condemned by
    its own ServeMetrics counters and drained before it destroys its
    whole queue."""

    class BrokenModel(MockModel):
        def decode(self, params, cache, tokens, pos):
            raise RuntimeError("hardware gone")

    cfg = ServeConfig(buckets=BucketPolicy(batch=(1, 2, 4), seq=(32,)),
                      use_lilac=False, jit_prefill=False)
    healthy = Engine(MockModel(), params=None, config=cfg)
    broken = Engine(BrokenModel(), params=None, config=cfg)
    fd = FrontDoor([healthy, broken], fault_streak=2)
    reqs = _submit_many(fd, 10, max_new=4)
    fd.run_until_idle()
    assert not fd.replicas[1].healthy
    assert "unhealthy" in fd.replicas[1].reason
    assert fd.accounted()
    # casualties are only the slots poisoned before the streak tripped;
    # everything drained afterwards finished correctly on the survivor
    for r in reqs:
        if r.failed is None:
            assert r.tokens == _solo_stream(list(r.prompt),
                                            r.max_new_tokens)
        else:
            assert r.failed.startswith("decode")
    assert fd.redistributed > 0


def test_a_fault_of_the_card_raises_through_engine_and_front_door():
    """On the card only an injected fault or out of memory is contained:
    another error of a decode step (a kernel that does not launch) raises
    through the engine and the front door instead of evicting requests
    or retiring the replica."""

    class KernelBroken(MockModel):
        def decode(self, params, cache, tokens, pos):
            raise RuntimeError("gmm launch failed: cudaError 9")

    cfg = ServeConfig(buckets=BucketPolicy(batch=(2,), seq=(32,)),
                      use_lilac=False, jit_prefill=False)
    eng = Engine(KernelBroken(), params=None, config=cfg)
    eng.device = torch.device("cuda")       # as an engine on the card
    eng._as_input = lambda a: a             # (its inputs stay numpy here)
    assert eng.contains(faults.InjectedFault("decode_raise", "decode"))
    assert eng.contains(torch.cuda.OutOfMemoryError("out of memory"))
    fd = FrontDoor([eng])
    assert fd.submit(_req([1, 2, 3], 4))
    with pytest.raises(RuntimeError, match="cudaError 9"):
        fd.step()
    assert fd.replicas[0].healthy and eng.metrics.decode_faults == 0


# ---------------------------------------------------------------------------
# adaptive shadow rate (unit)
# ---------------------------------------------------------------------------

def test_adaptive_shadow_rate_floor_reread(monkeypatch):
    monkeypatch.delenv("LILAC_TORCH_SHADOW_RATE", raising=False)
    a = R.AdaptiveShadowRate()
    assert a.floor() == 0.0 and a.effective() == 0.0
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "0.25")
    assert a.floor() == 0.25                  # re-read, not compile-cached
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "2.5")
    assert a.floor() == 1.0                   # clamped
    b = R.AdaptiveShadowRate(floor=0.125)
    assert b.floor() == 0.125                 # explicit override wins
    monkeypatch.setenv("LILAC_TORCH_REQUEST_SHADOW_RATE", "0.5")
    assert R.AdaptiveShadowRate(R.ENV_REQUEST_SHADOW).floor() == 0.5


def test_adaptive_shadow_rate_spike_and_decay(monkeypatch):
    monkeypatch.delenv("LILAC_TORCH_SHADOW_SPIKE", raising=False)
    monkeypatch.delenv("LILAC_TORCH_SHADOW_DECAY", raising=False)
    a = R.AdaptiveShadowRate(floor=0.05)
    a.spike("divergence")
    assert a.multiplier == 16.0
    assert a.effective() == pytest.approx(0.8)
    assert a.peak_multiplier == 16.0
    seen = []
    for _ in range(5):
        a.clean()
        seen.append(a.multiplier)
    assert seen == [8.0, 4.0, 2.0, 1.0, 1.0]  # geometric, floored at 1
    assert a.effective() == pytest.approx(0.05)
    assert a.peak_multiplier == 16.0          # peak is sticky for gates
    a.spike("again")
    assert a.clean_streak == 0


def test_adaptive_shadow_rate_env_knobs(monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_SHADOW_SPIKE", "4")
    monkeypatch.setenv("LILAC_TORCH_SHADOW_DECAY", "0.25")
    a = R.AdaptiveShadowRate(floor=1.0)
    a.spike("x")
    assert a.multiplier == 4.0
    assert a.effective() == 1.0               # capped at 1
    a.clean()
    assert a.multiplier == 1.0                # 4 * 0.25
    snap = a.snapshot()
    assert snap["spike"] == 4.0 and snap["decay"] == 0.25
    assert snap["incidents"] == 1 and snap["checks"] == 1


# ---------------------------------------------------------------------------
# request-level shadow verification
# ---------------------------------------------------------------------------

def test_request_shadow_clean_streak():
    fd = _mock_fleet(2, request_shadow_rate=1.0)
    _submit_many(fd, 8, max_new=5)
    fd.run_until_idle()
    snap = fd.snapshot()
    assert snap["resilience"]["request_shadow_checks"] == 8
    assert snap["resilience"]["request_shadow_divergences"] == 0
    assert snap["resilience"]["request_shadow_peak_multiplier"] == 1.0


def test_request_shadow_forced_divergence_spikes_then_decays():
    eng = Engine(MockModel(), params=None, config=ServeConfig(
        buckets=BucketPolicy(batch=(1, 2), seq=(32,)),
        use_lilac=False, jit_prefill=False, request_shadow_rate=1.0))
    assert eng.submit(_req([1, 2, 3], 4))
    with faults.inject("shadow_diverge:request"):
        eng.run_until_idle()
    assert eng.metrics.request_shadow_divergences == 1
    shadow = eng._request_shadow
    assert shadow.peak_multiplier >= 8.0
    for i in range(8):                        # clean traffic decays the spike
        assert eng.submit(_req([7 + i, 8, 9], 3))
    eng.run_until_idle()
    assert eng.metrics.request_shadow_divergences == 1
    assert shadow.multiplier < 2.0
    assert shadow.peak_multiplier >= 8.0


def test_request_shadow_sampling_is_stratified():
    eng = Engine(MockModel(), params=None, config=ServeConfig(
        buckets=BucketPolicy(batch=(1, 2), seq=(32,)),
        use_lilac=False, jit_prefill=False, request_shadow_rate=0.25))
    for i in range(8):
        assert eng.submit(_req([i + 1, 2, 3], 3))
    eng.run_until_idle()
    assert eng.metrics.request_shadow_checks == 2     # 8 finishes * 0.25


def test_request_shadow_rate_from_the_environment(monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_REQUEST_SHADOW_RATE", "1")
    monkeypatch.setenv("LILAC_REQUEST_SHADOW_RATE", "0")  # the JAX package's
    eng = _mock_engine(batch=(1, 2), seq=(32,))
    for i in range(3):
        assert eng.submit(_req([i + 1, 2, 3], 3))
    eng.run_until_idle()
    assert eng.metrics.request_shadow_checks == 3


def test_replay_solo_runs_at_the_batched_buckets():
    """The request shadow's replay re-decodes at each step's bucket: the
    recorded (batch, seq) of every decode step that gave a token."""
    eng = _mock_engine(batch=(1, 2, 4), seq=(16, 32))
    a, b = _req([1, 2, 3], 6), _req([4, 5], 2)
    assert eng.submit(a) and eng.submit(b)
    eng.run_until_idle()
    assert a.decode_buckets[0] == (2, 16)      # batched with b
    assert a.decode_buckets[-1] == (1, 16)     # alone after b left
    assert len(a.decode_buckets) == len(a.tokens) - 1
    assert eng.replay_solo(a) == a.tokens


# ---------------------------------------------------------------------------
# empty-series metrics guard
# ---------------------------------------------------------------------------

def test_zero_request_replica_snapshots_cleanly():
    """A replica that served nothing must snapshot (and JSON-serialize)
    without raising — fleet aggregation hits this on every fresh boot."""
    fd = _mock_fleet(3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # numpy empty-slice warnings
        snap = fd.snapshot()
    assert snap["fleet"]["submitted"] == 0
    assert snap["fleet"]["all_requests_accounted_for"]
    rep = snap["replicas"][0]["metrics"]
    assert np.isnan(rep["ttft_s"]["p50"])
    assert rep["decode_step_s"]["histogram"] == {"edges_s": [], "counts": []}
    json.dumps(snap)                          # NaNs allowed, nothing raises


# ---------------------------------------------------------------------------
# cross-replica quarantine sharing: concurrent-writer JsonStore merge
# ---------------------------------------------------------------------------

_WRITER = """
import sys
from repro_torch.core.resilience import QuarantineStore
path, harness = sys.argv[1], sys.argv[2]
q = QuarantineStore(path)
q.load()
q.add("spmv_csr", harness, reason="chaos incident", site=harness)
print("ok")
"""


def test_concurrent_quarantine_writers_both_survive(tmp_path):
    """Two processes quarantine different harnesses into one store file;
    the flock merge-on-save keeps both records — the invariant that lets
    N replicas (or N hosts) share one incident store."""
    path = tmp_path / "quarantine.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER, str(path), harness],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for harness in ("cuda.ell", "torch.segment")]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    store = R.QuarantineStore(path)
    store.load()
    keys = set(store.active())
    assert "spmv_csr|cuda.ell|default" in keys
    assert "spmv_csr|torch.segment|default" in keys


# ---------------------------------------------------------------------------
# serving resilience (tests/test_resilience.py's serving tier)
# ---------------------------------------------------------------------------

def test_try_admit_backoff_and_deadline():
    s = Scheduler(2, queue_capacity=1)
    s.submit(Request(prompt=np.array([1]), max_new_tokens=1))
    sleeps = []
    ok = s.try_admit(Request(prompt=np.array([1]), max_new_tokens=1),
                     deadline=10.0, retries=4, backoff_s=0.01,
                     sleep=sleeps.append, clock=lambda: 0.0)
    assert not ok and sleeps == [0.01, 0.02, 0.04]     # bounded, doubling
    # deadline cuts the retry budget short
    t = iter([0.0, 0.0, 5.0]).__next__
    sleeps2 = []
    ok = s.try_admit(Request(prompt=np.array([1]), max_new_tokens=1),
                     deadline=1.0, retries=8, backoff_s=0.01,
                     sleep=sleeps2.append, clock=t)
    assert not ok and len(sleeps2) <= 1
    # a slot freeing mid-backoff lets the admit succeed
    calls = {"n": 0}

    def freeing_sleep(dt):
        calls["n"] += 1
        if calls["n"] == 2:
            s.waiting.popleft()

    ok = s.try_admit(Request(prompt=np.array([1]), max_new_tokens=1),
                     retries=8, backoff_s=0.001, sleep=freeing_sleep,
                     clock=lambda: 0.0)
    assert ok and calls["n"] == 2


def test_poisoned_request_evicted_survivors_bit_identical():
    """A decode fault evicts ONLY the poisoned request; every surviving
    stream matches its solo reference bit for bit (seed 0 of the chaos
    plan fails some requests and spares others — both sets non-empty)."""
    eng = _mock_engine(batch=(4,), seq=(64,))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, 50, size=4).astype(np.int32),
                    max_new_tokens=6) for _ in range(4)]
    with faults.inject("decode_raise:decode:0.15,decode_nan:decode:0.1",
                       seed=0):
        for r in reqs:
            assert eng.submit(r)
        finished = eng.run_until_idle()
    assert len(finished) == len(reqs)         # everyone terminates
    failed = [r for r in reqs if r.failed]
    survived = [r for r in reqs if r.failed is None]
    assert failed and survived
    for r in survived:
        assert list(r.tokens) == _solo_stream(list(r.prompt),
                                              r.max_new_tokens)
    snap = eng.metrics.snapshot()
    res = snap["resilience"]
    assert res["decode_faults"] >= len(failed)
    assert res["fault_evictions"] == len(failed)


def test_decode_fault_reasons_are_recorded():
    eng = _mock_engine(batch=(2,), seq=(64,))
    r1 = Request(prompt=np.array([3, 4], np.int32), max_new_tokens=4)
    with faults.inject("decode_raise:decode"):
        eng.submit(r1)
        eng.run_until_idle()
    assert r1.failed is not None and r1.failed.startswith("decode:")
    eng2 = _mock_engine(batch=(2,), seq=(64,))
    r2 = Request(prompt=np.array([3, 4], np.int32), max_new_tokens=4)
    with faults.inject("decode_nan:decode"):
        eng2.submit(r2)
        eng2.run_until_idle()
    assert r2.failed == "non-finite decode logits"


def test_deadline_evicts_active_and_waiting():
    """Requests past their deadline are evicted (active: via compaction;
    waiting: dropped from the queue) and counted separately."""
    now = {"t": 1.0}
    cfg = ServeConfig(buckets=BucketPolicy(batch=(1,), seq=(64,)),
                      use_lilac=False, jit_prefill=False, deadline_s=5.0)
    eng = Engine(MockModel(), params=None, config=cfg,
                 clock=lambda: now["t"])
    r_active = Request(prompt=np.array([1, 2], np.int32),
                       max_new_tokens=50)
    r_waiting = Request(prompt=np.array([3], np.int32), max_new_tokens=50)
    assert eng.submit(r_active) and eng.submit(r_waiting)
    assert r_active.deadline_s == 5.0                  # config default
    eng.step()                                         # admits r_active only
    assert eng.scheduler.n_active == 1
    now["t"] = 7.0                                     # both past deadline
    eng.run_until_idle()
    assert r_active.failed == "deadline"
    assert r_waiting.failed == "deadline"
    assert not eng.scheduler.waiting
    res = eng.metrics.snapshot()["resilience"]
    assert res["deadline_evictions"] == 2
    assert res["fault_evictions"] == 2


def test_engine_admit_deadline_uses_try_admit():
    """config.admit_deadline_s routes submission through bounded
    retry-with-backoff and records timeouts instead of raising."""
    eng = _mock_engine(batch=(1,), seq=(64,), queue_capacity=1,
                       admit_deadline_s=0.02)
    assert eng.submit(Request(prompt=np.array([1], np.int32),
                              max_new_tokens=2))
    t0 = time.perf_counter()
    ok = eng.submit(Request(prompt=np.array([2], np.int32),
                            max_new_tokens=2))
    dt = time.perf_counter() - t0
    assert not ok and dt < 5.0                         # bounded, not a spin
    res = eng.metrics.snapshot()["resilience"]
    assert res["admission_timeouts"] == 1
    assert res["admission_retries"] >= 1
    assert eng.metrics.rejected == 1


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16),
       p_raise=st.floats(0.0, 0.4), p_nan=st.floats(0.0, 0.4))
def test_serving_chaos_hypothesis(seed, p_raise, p_nan):
    """Property: under random decode-fault plans, batching terminates,
    nothing escapes, and every survivor matches its solo stream."""
    eng = _mock_engine(batch=(2, 4), seq=(64,))
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, 50, size=3).astype(np.int32),
                    max_new_tokens=5) for _ in range(5)]
    spec = (f"decode_raise:decode:{p_raise:.3f},"
            f"decode_nan:decode:{p_nan:.3f}")
    with faults.inject(spec, seed=seed):
        for r in reqs:
            assert eng.submit(r)
        eng.run_until_idle()
    for r in reqs:
        assert r.done
        if r.failed is None:
            assert list(r.tokens) == _solo_stream(list(r.prompt),
                                                  r.max_new_tokens)


# ---------------------------------------------------------------------------
# the compiled engine (smoke OLMoE on the CPU) under the serving faults
# ---------------------------------------------------------------------------

_POLICY = BucketPolicy(batch=(1, 2), seq=(32,))


def _requests(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 256, size=int(rng.integers(
        2, 9))).astype(np.int32), max_new_tokens=int(rng.integers(2, 8)))
        for _ in range(n)]


@pytest.fixture(scope="module")
def smoke_model():
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(
        moe_decode_impl="naive_flat")
    model = build_model(cfg)
    return model, tree_map(lambda a: a.float(), model.init(
        torch.Generator().manual_seed(3), "cpu"))


def test_compiled_engine_request_shadow_clean_then_forced(smoke_model):
    """The request shadow at rate 1 over the compiled decode: a fault-free
    run diverges nowhere and quarantines nothing; shadow_diverge:request
    reports a divergence, quarantines the decode's MoE harness and the
    next decode runs without it."""
    model, params = smoke_model
    eng = Engine(model, params, ServeConfig(buckets=_POLICY,
                                            jit_prefill=False,
                                            request_shadow_rate=1.0))
    reqs = _requests()
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    assert all(r.failed is None for r in reqs)
    assert eng.metrics.request_shadow_checks == len(reqs)
    assert eng.metrics.request_shadow_divergences == 0
    info = eng._decode.resilience_info()
    assert info["quarantine_active"] == 0
    assert info["containment"]["contained_exceptions"] == 0
    assert {n for _, n in eng._decode.last_selections} == {"torch.capacity"}
    r = Request(prompt=np.array([5, 6, 7], np.int32), max_new_tokens=3)
    with faults.inject("shadow_diverge:request"):
        assert eng.submit(r)
        eng.run_until_idle()
    assert eng.metrics.request_shadow_divergences == 1
    assert R.quarantined(R.shared_quarantine(), "moe_ffn", "torch.capacity")
    with pytest.warns(R.LilacContainmentWarning):
        assert eng.submit(Request(prompt=np.array([5, 6, 7], np.int32),
                                  max_new_tokens=2))
        eng.run_until_idle()
    assert "torch.capacity" not in {n for _, n in
                                    eng._decode.last_selections}


def test_compiled_fleet_survives_a_replica_crash(smoke_model):
    """Two replicas of the compiled engine on one model: the second's
    prewarm detects nothing (shared plan cache); replica_crash loses no
    request and every stream equals the fault-free run's."""
    model, params = smoke_model
    cfg = ServeConfig(buckets=_POLICY, jit_prefill=False)
    first = Engine(model, params, cfg)
    second = Engine(model, params, cfg)
    assert first.metrics.prewarm["detect_calls"] == len(_POLICY.grid())
    assert second.metrics.prewarm["detect_calls"] == 0
    clean = Engine(model, params, cfg)
    want = _requests()
    for r in want:
        assert clean.submit(r)
    clean.run_until_idle()
    fd = FrontDoor([first, second])
    got = _requests()
    for r in got:
        assert fd.submit(r)
    fd.step()
    with faults.inject("replica_crash:replica0"):
        fd.step()
    fd.run_until_idle()
    assert fd.accounted() and fd.failovers == 1 and fd.lost == 0
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_build_fleet_on_the_cpu():
    fd = build_fleet("olmoe-1b-7b", n_replicas=2, device="cpu",
                     config=ServeConfig(buckets=BucketPolicy(
                         batch=(1, 2), seq=(16,)), jit_prefill=False))
    assert len(fd.replicas) == 2
    assert fd.replicas[1].engine.model is fd.replicas[0].engine.model
    assert fd.replicas[1].engine.metrics.prewarm["detect_calls"] == 0
    r = Request(prompt=np.array([1, 2, 3], np.int32), max_new_tokens=3)
    assert fd.submit(r)
    fd.run_until_idle()
    assert len(r.tokens) == 3 and r.failed is None
