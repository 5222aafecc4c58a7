"""The port's distribution layer on gloo ranks on the CPU, held against the
JAX package: ``tests/test_distributed.py``'s two launcher runs, the mesh
path's loss and gradients against the reference's one-device step,
expert parallelism with experts padded to the model axis, and
``tests/test_checkpoint.py``'s resharding restore.

Every multi-rank case runs ``torch.distributed.run --standalone`` (a free
rendezvous port a launch) in a subprocess with a timeout of at most 300 s,
at smoke size in f32.  Tolerances: the sharded step's loss within 1e-5
relative of the reference's one-device loss on the same parameters
(carried across from numpy) and batch, every gathered gradient leaf
within relative L2 1e-4 of the reference's; the padded expert-parallel
layer within 1e-5 of the reference's ``_moe_grouped_shardmap``.  The
``lilac`` MoE is held against the reference's ``naive`` one (the function
the reference's lilac computes: it ignores the shard context), with the
port's inner compile on ``cuda.gmm``, whose plain version on the CPU
drops no pair (the CPU default, ``torch.capacity``, drops pairs past its
capacity, and on a mesh the other ranks' pairs count toward local expert
0's load).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.elastic import plan_remesh as jplan_remesh
from repro_torch.train.elastic import plan_remesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, BATCH = 32, 2
TIMEOUT = 300


def _torchrun(tmp_path, code: str, nproc: int, *args):
    """``code`` as a script under torchrun with ``nproc`` gloo ranks."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(code))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "LILAC_TORCH_PLAN_CACHE": str(tmp_path / "plans.json"),
           "LILAC_TORCH_QUARANTINE_CACHE": str(tmp_path / "quarantine.json"),
           "LILAC_TORCH_AUTOTUNE_CACHE": str(tmp_path / "autotune.json")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(script), *map(str, args)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the launcher (tests/test_distributed.py)
# ---------------------------------------------------------------------------

LAUNCH = """
import sys
import torch.distributed as dist
from repro_torch.launch.train import main
marker = sys.argv[1]
sys.argv = ["train"] + sys.argv[2:]
main()
if dist.get_rank() == 0:
    print(marker)
"""


@pytest.mark.parametrize("marker,nproc,args", [
    ("DIST_TRAIN_OK", 4, ["--arch", "olmoe-1b-7b", "--mesh-data", "2",
                          "--mesh-model", "2", "--moe-impl", "grouped"]),
    ("COMPRESS_OK", 4, ["--arch", "olmo-1b", "--mesh-data", "4",
                        "--mesh-model", "1", "--compress-grads"]),
])
def test_launcher_trains_on_a_mesh(tmp_path, marker, nproc, args):
    """The reference's two mesh runs of its launcher, under torchrun: the
    smoke OLMoE on (2, 2) with grouped expert parallelism and the smoke
    OLMo on (4, 1) with gradient compression, 3 steps each."""
    proc = _torchrun(tmp_path, LAUNCH, nproc, marker, *args, "--smoke",
                     "--steps", "3", "--batch", "4", "--seq", "32",
                     "--device", "cpu", "--backend", "gloo", "--ckpt-dir",
                     tmp_path / "ck")
    assert marker in proc.stdout, proc.stdout[-2000:]
    assert proc.stdout.count("final: loss") == 1      # rank 0 alone prints
    assert "mesh={'data'" in proc.stdout
    ck = JCheckpointer(str(tmp_path / "ck"))
    assert ck.latest_step() == 3


# ---------------------------------------------------------------------------
# the mesh path's loss and gradients against the reference
# ---------------------------------------------------------------------------

PARITY = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import lilac
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_rules
from repro_torch.models import build_model, layers as L, spec as S
from repro_torch.models.factory import params_from_numpy
from repro_torch.train import train_step as TS
from repro_torch.train.loop import shard_params

work, data, model = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cases = json.loads(sys.argv[4])
rank = init_distributed("gloo")
L._LILAC_MOE["cpu"] = lilac.compile(L._moe_naive_2d, platform="cpu",
                                    policy="cuda.gmm")
mesh = make_host_mesh(data, model)
rules = mesh_rules(False)
batch = {k: torch.from_numpy(v) for k, v in np.load(work + "/batch.npz").items()}
for case in cases:
    cfg = smoke_config(get_arch(case["arch"])).replace(
        spmd_constraints=True, mesh_axis_sizes=(("data", data), ("model", model)),
        seq_parallel=case["sp"], remat=case["remat"],
        **({"moe_impl": case["impl"]} if case["impl"] else {}))
    m = build_model(cfg)
    flat = dict(np.load(work + f"/{case['arch']}.npz"))

    def pick(tree, prefix=""):
        return {k: pick(v, prefix + k + "/") if isinstance(v, dict)
                else flat[prefix + k] for k, v in tree.items()}
    full = params_from_numpy(cfg, pick(m.spec))
    with C.use_mesh(mesh):
        psh = TS.param_shardings(m, mesh, rules)
        lp = shard_params(full, psh)
        lb = {k: C.local_of(v, TS.batch_pspec(rules)) for k, v in batch.items()}
        share, grads = TS.value_and_grad(m.loss_fn)(lp, lb)
        grads = TS._grad_constraint(grads, TS.storage_pspecs(m))
        loss = float(C.psum(share, ("data", "model")))
        gathered = S.tree_map(lambda g, sh: C.reshard(g, sh.spec, (None,) * g.dim()),
                              grads, psh)
    if rank == 0:
        np.savez(work + f"/{case['name']}.npz", loss=loss,
                 **{k: v.numpy() for k, v in S.leaves(gathered)})
dist.barrier()
"""


def _reference_params(tmp_path, arch):
    """The reference's smoke parameters (cast to f32) to an npz; returns
    the JAX model and parameters."""
    jm = jbuild_model(jsmoke(jget_arch(arch)))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    np.savez(tmp_path / f"{arch}.npz", **_flat(jp))
    return jm, jp


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_mesh_step_matches_the_reference_one_device_step(tmp_path, mesh):
    """The smoke OLMoE with grouped and lilac MoE, sequence parallelism on
    and off (the smoke OLMo's dense MLP and remat on (2, 2)): the summed
    loss shares and every gradient leaf, gathered, against the reference's
    value_and_grad on one device."""
    batch = JSyntheticLM(vocab=256, seq_len=SEQ, global_batch=BATCH,
                         seed=1).batch_at(0)
    np.savez(tmp_path / "batch.npz", **batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cases, want = [], {}
    for arch in ("olmoe-1b-7b", "olmo-1b"):
        jm, jp = _reference_params(tmp_path, arch)
        impls = ("grouped", "lilac") if arch == "olmoe-1b-7b" else (None,)
        for impl in impls:
            ref_impl = "naive" if impl == "lilac" else impl
            jcfg = jsmoke(jget_arch(arch))
            if ref_impl:
                jcfg = jcfg.replace(moe_impl=ref_impl)
            jl, jg = jax.value_and_grad(jbuild_model(jcfg).loss_fn)(jp, jbatch)
            for sp in (True, False):
                if arch == "olmo-1b" and not sp:
                    continue
                remat = arch == "olmo-1b"
                name = f"{arch}-{impl}-{sp}"
                cases.append({"name": name, "arch": arch, "impl": impl,
                              "sp": sp, "remat": remat})
                want[name] = (float(jl), _flat(jg))
    if mesh != (2, 2):
        cases = [c for c in cases if c["arch"] == "olmoe-1b-7b"]
    _torchrun(tmp_path, PARITY, mesh[0] * mesh[1], tmp_path, *mesh,
              json.dumps(cases))
    for c in cases:
        got = dict(np.load(tmp_path / f"{c['name']}.npz"))
        jl, jg = want[c["name"]]
        assert abs(float(got.pop("loss")) - jl) <= 1e-5 * abs(jl), c
        assert set(got) == set(jg), c
        for k, g in jg.items():
            assert _rel_l2(got[k], g) < 1e-4, (c, k)


# ---------------------------------------------------------------------------
# expert parallelism with experts padded to the model axis
# ---------------------------------------------------------------------------

JAX_EP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import get_arch, smoke_config
from repro.models import layers as L

cfg = smoke_config(get_arch("granite-moe-3b-a800m")).replace(moe_experts=5)
spec = L.moe_spec(cfg.d_model, cfg.d_ff, cfg.moe_experts)
from repro.models.spec import init_params
p = jax.tree.map(lambda a: a.astype(jnp.float32),
                 init_params(spec, jax.random.key(3)))
x = jax.random.normal(jax.random.key(4), (2, 32, cfg.d_model), jnp.float32)
mesh = compat.make_mesh((1, 2), ("data", "model"))
with compat.use_mesh(mesh):
    out, aux = L.moe_block(p, x, topk=cfg.moe_topk, impl="grouped",
                           capacity_factor=2.0,
                           shard_ctx={"batch_axes": ("data",),
                                      "model_axis": "model", "model_size": 2,
                                      "combine_bf16": False})
np.savez(sys.argv[1], x=np.asarray(x), out=np.asarray(out),
         aux=np.asarray(aux), **{k: np.asarray(v) for k, v in p.items()})
print("JAX_EP_OK")
"""

PORT_EP = """
import sys
import numpy as np, torch
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_rules
from repro_torch.models import layers as L, spec as S, transformer as T

rank = init_distributed("gloo")
mesh = make_host_mesh(1, 2)
cfg = smoke_config(get_arch("granite-moe-3b-a800m")).replace(
    moe_experts=5, spmd_constraints=True,
    mesh_axis_sizes=(("data", 1), ("model", 2)))
data = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[1]).items()}
spec = L.moe_param_spec(cfg.d_model, cfg.d_ff, cfg.moe_experts)
with C.use_mesh(mesh):
    storage = S.tree_pspecs(spec, mesh, mesh_rules(False))
    p = {k: C.local_of(data[k], storage[k]) for k in spec}
    p = T._ep_weights(cfg, T._constrain(cfg, spec, p))
    assert p["wg"].shape[0] == 3          # 5 experts padded to 6, 3 a rank
    ctx = T._moe_shard_ctx(cfg)._replace(sp=False)
    out, aux = L.moe_block(p, data["x"], topk=cfg.moe_topk, impl="grouped",
                           capacity_factor=2.0, shard_ctx=ctx)
if rank == 0:
    np.savez(sys.argv[2], out=out.numpy(), aux=aux.numpy())
"""


def test_expert_parallel_layer_pads_experts_like_the_reference(tmp_path):
    """A granite-moe smoke MoE layer with 5 experts on a (1, 2) mesh (the
    stack zero-padded to 6, 3 experts a rank, the capacity from the
    unpadded 5) against the reference's ``_moe_grouped_shardmap`` on a
    (1, 2) JAX mesh of host devices."""
    ref = tmp_path / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", JAX_EP, str(ref)],
                          env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert "JAX_EP_OK" in proc.stdout, proc.stderr[-2000:]
    _torchrun(tmp_path, PORT_EP, 2, ref, tmp_path / "port.npz")
    want, got = np.load(ref), np.load(tmp_path / "port.npz")
    assert _rel_l2(got["out"], want["out"]) < 1e-5
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the resharding checkpoint (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

CKPT = """
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models.spec import NamedSharding
from repro_torch.train.checkpoint import Checkpointer

work = sys.argv[1]
rank = init_distributed("gloo")
full = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
        "h": (torch.arange(32, dtype=torch.float32) / 7).to(torch.bfloat16),
        "step": torch.tensor(3, dtype=torch.int32)}
specs = {"w": ("data", "model"), "h": (("data", "model"),), "step": ()}


def shardings(mesh):
    return {k: NamedSharding(mesh, ps) for k, ps in specs.items()}


mesh1 = make_host_mesh(4, 2)
with C.use_mesh(mesh1):
    local = {k: C.local_of(v, specs[k]).clone() for k, v in full.items()}
    # a dimension over two mesh axes: DTensor's layout is JAX's
    # major-to-minor one, the data axis major
    sh = shardings(mesh1)["h"]
    assert torch.equal(distribute_tensor(full["h"], mesh1, sh.placements,
                                         src_data_rank=None).to_local(),
                       local["h"])
ck = Checkpointer(work)
ck.save(1, local, shardings=shardings(mesh1))
assert ck.latest_step() == 1                # every rank sees the commit

mesh2 = make_host_mesh(2, 4)
with C.use_mesh(mesh2):
    want = {k: C.local_of(v, specs[k]) for k, v in full.items()}
out = ck.restore(1, {k: torch.zeros_like(v) for k, v in want.items()},
                 shardings=shardings(mesh2))
for k in full:
    assert out[k].dtype == full[k].dtype and torch.equal(out[k], want[k]), k
if rank == 0:
    one = ck.restore(1, {k: torch.zeros_like(v) for k, v in full.items()})
    assert all(torch.equal(one[k], full[k]) for k in full)
    print("ELASTIC_OK")
dist.barrier()
"""


def test_elastic_reshard_across_mesh_shapes(tmp_path):
    """Saved on a (4, 2) mesh of 8 gloo ranks, restored onto (2, 4) and
    onto one device bit for bit; the files load with the reference's
    ``Checkpointer.restore`` to the same values."""
    proc = _torchrun(tmp_path, CKPT, 8, tmp_path / "ck")
    assert "ELASTIC_OK" in proc.stdout
    got = JCheckpointer(str(tmp_path / "ck")).restore(1, {
        "w": jnp.zeros((8, 8), jnp.float32),
        "h": jnp.zeros((32,), jnp.bfloat16),
        "step": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(got["w"]),
                                  np.arange(64, dtype=np.float32)
                                  .reshape(8, 8))
    np.testing.assert_array_equal(
        np.asarray(got["h"]).astype(np.float32),
        np.asarray(jnp.asarray(np.arange(32, dtype=np.float32) / 7,
                               jnp.bfloat16)).astype(np.float32))
    assert int(got["step"]) == 3


@pytest.mark.parametrize("n,m", [(512, 16), (496, 16), (8, 2), (7, 7)])
def test_plan_remesh_matches_the_reference(n, m):
    assert plan_remesh(n, m) == jplan_remesh(n, m)


def test_plan_remesh_refuses_fewer_ranks_than_the_model_axis():
    with pytest.raises(AssertionError):
        jplan_remesh(8, 16)
    with pytest.raises(AssertionError):
        plan_remesh(8, 16)


# ---------------------------------------------------------------------------
# prefill and decode on the mesh (the dry-run's serve steps)
# ---------------------------------------------------------------------------

SERVE = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_rules
from repro_torch.models import build_model, spec as S
from repro_torch.train import train_step as TS
from repro_torch.train.loop import shard_params

work = sys.argv[1]
cases = json.loads(sys.argv[2])
rank = init_distributed("gloo")
mesh = make_host_mesh(2, 2)
rules = mesh_rules(False)
out = {}
for case in cases:
    cfg = smoke_config(get_arch(case["arch"])).replace(
        decode_cache_seq_shard=case["seq_shard"])
    one = build_model(cfg)
    params = S.tree_map(lambda a: a.float(),
                        one.init(torch.Generator().manual_seed(0)))
    B, prompt, cap = case["batch"], 8, 16
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, prompt + 1), generator=g)
    with torch.no_grad():
        logits1, caches = one.prefill(params, {"tokens": tokens[:, :prompt]})
        cache = one.cache_from_prefill(caches, prompt, cap)
        step1, new1 = one.decode(params, cache, tokens[:, prompt:], prompt)
    mm = build_model(cfg.replace(spmd_constraints=True,
                                 mesh_axis_sizes=(("data", 2), ("model", 2))))
    shape = ShapeConfig("tiny", cap, B, "decode")
    with C.use_mesh(mesh), torch.no_grad():
        lp = shard_params(params, TS.param_shardings(mm, mesh, rules))
        bsh = TS.batch_shardings(mm, shape, mesh, rules)
        specs = S.tree_map(lambda sh: sh.spec, bsh["cache"])
        lcache = S.tree_map(lambda a, ps: C.local_of(a, ps).clone(), cache,
                            specs)
        tok = C.local_of(tokens, bsh["tokens"].spec)
        logits, _ = mm.prefill(lp, {"tokens": tok[:, :prompt]})
        step, new = mm.decode(lp, lcache, tok[:, prompt:], prompt, specs)
        full = S.tree_map(lambda a, ps: C.reshard(a, ps, (None,) * a.dim()),
                          new, specs)
        gather = lambda x: C.reshard(x, bsh["tokens"].spec, (None, None))
        logits, step = gather(logits), gather(step)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))
    out[case["name"]] = {
        "prefill": rel(logits, logits1), "decode": rel(step, step1),
        "cache": max(rel(a, b) for (_, a), (_, b) in
                     zip(S.leaves(full), S.leaves(new1)))}
if rank == 0:
    print("SERVE " + json.dumps(out))
dist.barrier()
"""


def test_prefill_and_decode_on_the_mesh_match_one_device(tmp_path):
    """The smoke models' prefill logits and one decode step on a (2, 2)
    mesh against the same port model on one device (itself held against
    the reference's prefill and decode by test_torch_serve and
    test_torch_archs), f32: the decode cache at batch_shardings' rules
    (kv heads over the model axis, an MQA cache by sequence over it with
    decode_cache_seq_shard, a batch of 1 by sequence over the data axis,
    RWKV-6's state by heads and Mamba's by its inner dim), the logits and
    every new cache leaf within 1e-5 relative L2."""
    cases = [
        {"name": "olmoe", "arch": "olmoe-1b-7b", "batch": 2,
         "seq_shard": False},
        {"name": "granite34-mqa", "arch": "granite-34b", "batch": 2,
         "seq_shard": True},
        {"name": "olmo-b1", "arch": "olmo-1b", "batch": 1,
         "seq_shard": False},
        {"name": "rwkv", "arch": "rwkv6-1.6b", "batch": 2,
         "seq_shard": False},
        {"name": "jamba", "arch": "jamba-v0.1-52b", "batch": 2,
         "seq_shard": False},
    ]
    proc = _torchrun(tmp_path, SERVE, 4, tmp_path, json.dumps(cases))
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("SERVE "))
    got = json.loads(line[len("SERVE "):])
    for name, r in got.items():
        assert max(r.values()) < 1e-5, (name, r)
