"""The mesh's compiled training step on gloo ranks on the CPU: the smoke
OLMoE on a (data 1, model 2) mesh, its MoE ``grouped`` and ``lilac``
(the inner compile on ``cuda.gmm``, whose plain version on the CPU drops
nothing), two steps of ``train_loop`` compiled with ``aot_eager`` against
the same loop uncompiled (``backend=None``) from the same parameters.

The collectives stage through the host and are graph breaks
(``launch.collectives``), and so is ``torch.autograd.grad``: the entry
counts its graphs and breaks.  The first loss equals the eager mesh
step's bit for bit; the second is within 1e-4 relative: under the trace
the lilac MoE's backward recomputes its dispatch at the token count, the
eager one at the largest expert load (``_moe_ffn_bwd``), so the
gradients round apart and Adam's first update moves an entry whose
gradient is ~0 by a sign that rounding decides.  One
``torch.distributed.run`` of 2 ranks, at most 300 s, as
``tests/test_torch_distributed.py`` runs its cases."""
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 300

WORKER = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch import lilac
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_rules
from repro_torch.models import build_model, layers as L
from repro_torch.train import optim as O
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, train_loop

rank = init_distributed("gloo")
L._LILAC_MOE["cpu"] = lilac.compile(L._moe_naive_2d, platform="cpu",
                                    policy="cuda.gmm")
mesh = make_host_mesh(1, 2)
rules = mesh_rules(False)
opt = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
out = {}
for impl in ("grouped", "lilac"):
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(
        spmd_constraints=True, mesh_axis_sizes=(("data", 1), ("model", 2)),
        moe_impl=impl)
    model = build_model(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=1)
    for backend in (None, "aot_eager"):
        r = train_loop(model, opt, LoopConfig(steps=2, log_every=100),
                       data.batch_at, device="cpu", mesh=mesh, rules=rules,
                       backend=backend, emit=lambda s: None)
        out[f"{impl}/{backend}"] = {"history": r["history"],
                                    "compiled": r["compiled"]}
if rank == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def test_mesh_compiled_step_equals_the_eager_mesh_step(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "LILAC_TORCH_PLAN_CACHE": str(tmp_path / "plans.json"),
           "LILAC_TORCH_QUARANTINE_CACHE": str(tmp_path / "quarantine.json"),
           "LILAC_TORCH_AUTOTUNE_CACHE": str(tmp_path / "autotune.json")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(tmp_path / "out.json")],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads((tmp_path / "out.json").read_text())
    for impl in ("grouped", "lilac"):
        eager, comp = out[f"{impl}/None"], out[f"{impl}/aot_eager"]
        print(impl, comp["compiled"])
        assert eager["compiled"] is None
        assert len(comp["history"]) == 2
        assert comp["history"][0] == eager["history"][0], (impl, comp, eager)
        assert abs(comp["history"][1] - eager["history"][1]) \
            <= 1e-4 * abs(eager["history"][1]), (impl, comp, eager)
        stats = comp["compiled"]
        assert not stats["fullgraph"] and stats["calls"] == 2
        # the collectives and the gradient break the step into pieces
        assert stats["compiles"] > 1 and stats["graph_breaks"] > 0
