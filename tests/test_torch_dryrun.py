"""The port's sharding rules and dry-run accounting, held against the JAX
package: every leaf's partition spec of all ten configs on the (16, 16),
(2, 16, 16) and (2, 2) meshes (parameters at the storage and the compute
rules, the optimizer state with and without ``compress_grads``, the
batch of each shape kind, the prefill's caches, the decode cache with and
without ``decode_cache_seq_shard``), and one reduced dry-run cell (the
smoke OLMoE's train step on a (2, 2) layout) against the reference's
compiled one: the per-device argument bytes equal to its
``memory_analysis()``, the per-device FLOPs within 5 % of its HLO walk.

Nothing compiles on the port's side and no process group of the mesh's
size starts; the reference's specs come from ``AbstractMesh`` (its
prefill cache rule evaluates the prefill's shapes without a mesh).
"""
import contextlib
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import compat
from repro.configs import all_archs as jall_archs
from repro.configs.base import SHAPES as JSHAPES
from repro.models import build_model as jbuild_model
from repro.models import spec as JS
from repro.train import optim as JO
from repro.train import train_step as JTS
from repro_torch.configs import SHAPES, get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import perf
from repro_torch.launch.mesh import mesh_rules
from repro_torch.models import build_model
from repro_torch.models import spec as S
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "host": {"data": 2, "model": 2}}
ARCHS = sorted(jall_archs())


def _jflat(tree):
    """name -> partition spec tuple of a JAX tree of NamedSharding / P."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, (jax.sharding.Sharding,
                                                   JS.P)))[0]:
        spec = v.spec if isinstance(v, jax.sharding.Sharding) else v
        out["/".join(str(getattr(k, "key", k)) for k in path)] = tuple(spec)
    return out


def _tflat(tree):
    """name -> partition spec tuple of a port tree of NamedSharding /
    tuples."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            out["/".join(prefix)] = tuple(t.spec if isinstance(
                t, S.NamedSharding) else t)
    walk(tree, ())
    return out


def _models(arch):
    return jbuild_model(jall_archs()[arch]), build_model(get_arch(arch))


def _jmesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_optimizer_specs_match_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    jm, tm = _models(arch)
    multi = "pod" in sizes
    jrules, rules = JS.MULTI_POD_RULES if multi else JS.SINGLE_POD_RULES, \
        mesh_rules(multi)
    assert rules == jrules
    jmesh = _jmesh(sizes)
    assert _tflat(S.tree_pspecs(tm.spec, sizes, rules)) == \
        _jflat(JS.tree_pspecs(jm.spec, jmesh, jrules))
    assert _tflat(S.compute_pspecs(tm.spec, sizes)) == \
        _jflat(JS.compute_pspecs(jm.spec, sizes))
    for compress in (False, True):
        got = _tflat(TS.opt_state_shardings(
            tm, O.AdamWConfig(compress_grads=compress), sizes, rules))
        want = _jflat(JTS.opt_state_shardings(
            jm, JO.AdamWConfig(compress_grads=compress), jmesh, jrules))
        assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, mesh, monkeypatch):
    sizes = MESHES[mesh]
    multi = "pod" in sizes
    jrules, rules = JS.MULTI_POD_RULES if multi else JS.SINGLE_POD_RULES, \
        mesh_rules(multi)
    jmesh = _jmesh(sizes)
    # the reference's prefill cache rule reads only the prefill's shapes,
    # which its eval_shape gives without an ambient mesh
    monkeypatch.setattr(compat, "use_mesh",
                        lambda m: contextlib.nullcontext())
    for seq_shard in (False, True):
        jcfg = jall_archs()[arch].replace(decode_cache_seq_shard=seq_shard)
        cfg = get_arch(arch).replace(decode_cache_seq_shard=seq_shard)
        jm, tm = jbuild_model(jcfg), build_model(cfg)
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            assert _tflat(TS.batch_shardings(tm, shape, sizes, rules)) == \
                _jflat(JTS.batch_shardings(jm, jshape, jmesh, jrules)), name
            if shape.kind == "prefill" and not seq_shard:
                assert _tflat(TS.prefill_cache_shardings(
                    tm, shape, sizes, rules)) == _jflat(
                        JTS.prefill_cache_shardings(jm, jshape, jmesh,
                                                    jrules))


def test_placements_of_a_dimension_over_two_axes():
    """("pod", "data") on one dimension is Shard(d) on both mesh
    dimensions, in mesh order; an order the mesh does not have raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert S.placements((("pod", "data"), "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(1)]
    assert S.placements((None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh's"):
        S.placements((("data", "pod"),), Mesh())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_specs_are_the_prefills_caches(arch):
    """``Model.prefill_cache_specs`` (the shapes the dry-run's sharding
    trees read) against the caches the smoke model's prefill returns."""
    cfg = smoke_config(get_arch(arch))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig("tiny", 8, 2, "prefill")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in m.input_specs(shape).items()}
    with torch.no_grad():
        _, caches = m.prefill(params, batch)
    want = S.tree_map(lambda t: (tuple(t.shape), t.dtype), caches)
    got = S.tree_map(lambda t: (tuple(t.shape), t.dtype),
                     m.prefill_cache_specs(shape))
    assert got == want


def test_moe_ffn_flop_formula_counts_k4s_padded_rows():
    from torch.utils.flop_counter import FlopCounterMode

    DR.register_moe_ffn_flops()
    T, K, E, D, F, tm = 8, 2, 4, 16, 8, 128
    g = torch.Generator().manual_seed(0)
    x = torch.randn(T, D, generator=g)
    gate = torch.rand(T, K, generator=g)
    idx = torch.randint(0, E, (T, K), generator=g, dtype=torch.int32)
    ws = [torch.randn(s, generator=g) for s in ((E, D, F), (E, D, F),
                                                (E, F, D))]
    with FlopCounterMode(display=False) as fc:
        gmm_ops.moe_ffn_op(x, gate, idx, *ws, tm)
    tp = -(-T * K // tm) * tm + (E - 1) * tm
    assert fc.get_total_flops() == 3 * 2 * tp * D * F


def test_skipped_cells_give_the_references_reason():
    from repro.configs.base import shape_skips as jshape_skips
    for arch in ("olmoe-1b-7b", "hubert-xlarge"):
        for name in ("long_500k", "decode_32k"):
            res = DR.analyze_cell(arch, name, False)
            want = jshape_skips(jall_archs()[arch], JSHAPES[name])
            if want is None:
                continue
            assert res == {"arch": arch, "shape": name, "mesh": "single",
                           "status": "skip", "reason": want}


def test_perf_experiments_are_the_references():
    code = ("import json, repro.launch.perf as P; "
            "print(json.dumps(P.EXPERIMENTS))")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        json.loads(json.dumps(perf.EXPERIMENTS))


REFERENCE_CELL = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro import compat
from repro.configs import get_arch, smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as DR
from repro.launch.mesh import mesh_rules
from repro.models import build_model
from repro.train import optim as O, train_step as TS

out = {}
for impl in ("grouped", "naive"):
    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(
        moe_impl=impl, spmd_constraints=True,
        mesh_axis_sizes=(("data", 2), ("model", 2)))
    model = build_model(cfg)
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    rules = mesh_rules(False)
    shape = ShapeConfig("smoke", 32, 4, "train")
    opt_cfg = O.AdamWConfig()
    step = TS.make_train_step(model, opt_cfg)
    pshard = TS.param_shardings(model, mesh, rules)
    oshard = TS.opt_state_shardings(model, opt_cfg, mesh, rules)
    bshard = TS.batch_shardings(model, shape, mesh, rules)
    abs_params = model.abstract_params()
    abs_opt = jax.eval_shape(lambda p: O.adamw_init(opt_cfg, p), abs_params)
    with compat.use_mesh(mesh):
        compiled = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                           out_shardings=(pshard, oshard, None),
                           donate_argnums=(0, 1)).lower(
            abs_params, abs_opt, model.input_specs(shape)).compile()
    out[impl] = {"argument_size_in_bytes":
                 int(compiled.memory_analysis().argument_size_in_bytes),
                 "flops": DR.analyze_hlo(compiled.as_text())["flops"]}
print(json.dumps(out))
"""

PORT_CELL = """
import json
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR

out = {}
for impl in ("grouped", "naive"):
    r = DR.analyze_cell(
        "olmoe-1b-7b", "train_4k", False,
        arch_overrides={"moe_impl": impl, "microbatches": 1},
        axis_sizes={"data": 2, "model": 2},
        shape=ShapeConfig("smoke", 32, 4, "train"), smoke=True)
    out[impl] = {"argument_size_in_bytes":
                 r["memory"]["argument_size_in_bytes"], "flops": r["flops"]}
print(json.dumps(out))
"""


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code],
                          env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reduced_cell_bytes_and_flops_match_the_reference():
    """The smoke OLMoE's train step on a (2, 2) layout, grouped and naive
    MoE: the port's per-device argument bytes equal the reference's
    ``memory_analysis()`` (parameters, AdamW state, batch), and its
    per-device FLOPs are within 5 % of the reference's ``analyze_hlo``.
    The port's are the larger by the router's product, which it computes
    on the whole gathered sequence on each model rank (the reference's
    partitioner computes it on the rank's sequence chunk): 196,608
    FLOPs here (the forward 2·32·64·8 on each of 2 sequences and its
    backward's two products), 1 % of the step."""
    want, got = _run(REFERENCE_CELL), _run(PORT_CELL)
    for impl in ("grouped", "naive"):
        assert got[impl]["argument_size_in_bytes"] == \
            want[impl]["argument_size_in_bytes"]
        assert abs(got[impl]["flops"] / want[impl]["flops"] - 1) < 0.05, impl


def test_dryrun_cli_runs_a_production_cell_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape
    train_4k --mesh single`` finishes with status ok: rank 0's step of
    256 on fake tensors under a fake process group."""
    out = tmp_path / "cell.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmoe-1b-7b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(out)], env={**os.environ, "PYTHONPATH": SRC},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["status"] == "ok" and res["n_devices"] == 256
    assert res["flops"] > 0 and res["memory"]["argument_size_in_bytes"] > 0
    assert res["collectives"]["all_gather"]["calls"] > 0
