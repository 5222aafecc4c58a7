"""The port's examples (``python -m repro_torch.examples.<name>``) at a
small size on the CPU: what each one computes through ``lilac.compile``
agrees with its naive formulation.

The autouse fixture points ``LILAC_TORCH_AUTOTUNE_CACHE`` into
``tmp_path``, so no test writes to ``~/.cache``.
"""
import pytest
import torch

from repro_torch import lilac
from repro_torch.core.harness import REGISTRY
from repro_torch.examples import pagerank
from repro_torch.examples import serve as serve_example
from repro_torch.examples.common import naive_spmv
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

NODES, ITERS = 512, 40


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
    REGISTRY.reset_autotuner()
    yield
    REGISTRY.reset_autotuner()


def test_pagerank_links_are_column_stochastic():
    """Each linked page splits its rank among its out-links: the weights
    of a column sum to one."""
    g, val = pagerank.links(NODES, "cpu")
    col = g.col_ind.long()
    sums = torch.zeros(NODES).index_add_(0, col, val)
    linked = torch.unique(col)
    torch.testing.assert_close(sums[linked], torch.ones(len(linked)))


@pytest.mark.parametrize("policy", ["default", "cuda.ell", "autotune"])
def test_pagerank_keeps_the_iterate_a_distribution(policy):
    """40 iterations through the compiled SpMV keep the iterate's sum in
    [0.15, 1] and agree with the naive SpMV's to f32 rounding: with
    unnormalized links it would grow to ~1e25."""
    g, val = pagerank.links(NODES, "cpu")
    spmv = lilac.compile(naive_spmv, mode="host", policy=policy,
                         device="cpu")
    x = pagerank.pagerank(spmv, g, val, ITERS)
    want = pagerank.pagerank(naive_spmv, g, val, ITERS)
    assert 0.15 <= float(x.sum()) <= 1.0 + 1e-5
    torch.testing.assert_close(x, want, atol=1e-7, rtol=1e-5)
    assert len(spmv.last_selections) == 1


def test_serve_example_on_the_cpu(capsys):
    """``python -m repro_torch.examples.serve --device cpu``: every request
    finishes on prewarmed buckets, the decode's MoE layers run as matches
    (the CPU's ``torch.capacity``) from baked plans."""
    snap = serve_example.main(["--device", "cpu", "--requests", "4",
                               "--tokens", "4"])
    assert snap["requests"]["finished"] == 4
    assert snap["buckets"]["misses"] == 0
    assert snap["prewarm"]["baked"] == snap["prewarm"]["n_signatures"] == 6
    out = capsys.readouterr().out
    assert "selections: ['torch.capacity', 'torch.capacity']" in out
