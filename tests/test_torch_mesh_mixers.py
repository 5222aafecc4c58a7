"""The recurrent mixers tensor-parallel on the mesh: RWKV-6's time mix by
heads and its channel mix by d_ff, Mamba by its inner dim (its
``in_proj`` exchanged from the contiguous storage block to the rank's x
and z columns), as the reference's compute rules split them.

One ``torchrun`` of 4 gloo ranks runs every case on the CPU, in f32, on
the smoke RWKV-6 and the smoke Jamba with the reference's parameters
carried across (the smoke Jamba also cut to its two Mamba layers, and a
smoke RWKV-6 with one head and an odd d_ff, which the model axis does not
divide, on the replicated route): on a (1, 2) mesh (two replicas of it
over an outer axis) and on (2, 2) (the 16-layer smoke Jamba on (2, 2)
only), the forward, the train step's loss and every gradient leaf, and a
prefill plus 4 decode steps (the prefill's caches turned into the decode
cache on each rank, its recurrent leaves the rank's blocks).  Each is
held against the one-device port on the same parameters and tokens
(1e-5 relative L2, or twice the one-device port's own f32 spread where
the model amplifies rounding past it: ``test_mesh_mixers_match_one_device``
says where), and against the reference's one-device results, computed in
this process while the ranks run (``test_torch_distributed``'s bounds:
``test_mesh_mixers_match_the_reference``).  The collective counters
(``collectives._count``, by axis) show that no mixer weight and no
recurrent state is all-gathered over the model axis: the only
all-gathers over it are of the logits.

Two dry-run cells on a (2, 2) layout against the reference's compiled
ones (``test_torch_dryrun``'s pattern): the smoke RWKV-6's and the smoke
Jamba's (cut to its two Mamba layers) train step, per-device argument
bytes equal to the reference's ``memory_analysis()`` and FLOPs within 5 % of its ``analyze_hlo``, no
``replicated_mixer_forward_flops`` for a dividing axis, and a peak
memory of at least the argument bytes.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import build_model as jbuild_model
from repro.models import transformer as JT
from test_torch_distributed import _flat, _torchrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, BATCH, PROMPT, STEPS = 32, 2, 8, 4
TOL = 1e-5
REF_TOL = 1e-4       # each leaf against the reference, test_torch_distributed's
CASES = {"rwkv": ("rwkv6-1.6b", {}),
         "jamba": ("jamba-v0.1-52b", {}),
         "jamba-2": ("jamba-v0.1-52b", {"attn_layer_period": 2,
                                        "n_layers": 2}),
         "rwkv-odd": ("rwkv6-1.6b", {"n_heads": 1, "d_ff": 129})}

WORKER = """
import json, sys
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import init_distributed, mesh_rules
from repro_torch.models import build_model, spec as S
from repro_torch.models import transformer as T
from repro_torch.models.factory import params_from_numpy
from repro_torch.train import train_step as TS
from repro_torch.train.loop import shard_params

work = sys.argv[1]
cases = json.loads(sys.argv[2])
rank = init_distributed("gloo")
rules = mesh_rules(False)
data = dict(np.load(work + "/tokens.npz"))
batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
tokens = torch.from_numpy(data["serve"])
P, steps = int(data["prompt"]), int(data["steps"])

log = []
count = C._count


def logged(kind, x, axis):
    log.append([kind, axis, list(x.shape)])
    count(kind, x, axis)


C._count = logged


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def full(t, ps):
    return C.reshard(t, ps, (None,) * t.dim())


out = {}
# a (1, 2) mesh twice over an outer axis: the model's mesh is the rank's
# (data, model) submesh
meshes = {(d, m): init_device_mesh("cpu", (4 // (d * m), d, m),
                                   mesh_dim_names=("rep", "data", "model"))[
    "data", "model"] for d, m in ((1, 2), (2, 2))}
for case in cases:
    cfg = smoke_config(get_arch(case["arch"])).replace(**case["over"])
    one = build_model(cfg)
    flat = dict(np.load(work + f"/{case['name']}.npz"))

    def pick(tree, prefix=""):
        return {k: pick(v, prefix + k + "/") if isinstance(v, dict)
                else flat[prefix + k] for k, v in tree.items()}
    params = params_from_numpy(cfg, pick(one.spec))
    cap = P + steps

    def one_device(params):
        loss, g = TS.value_and_grad(one.loss_fn)(params, batch)
        with torch.no_grad():
            x, _, _ = T.forward(cfg, params, batch)
            pre, caches = one.prefill(params, {"tokens": tokens[:, :P]})
            cache = one.cache_from_prefill(caches, P, cap)
            dec = []
            for t in range(steps):
                lg, cache = one.decode(params, cache,
                                       tokens[:, P + t:P + t + 1], P + t)
                dec.append(lg)
        return {"loss": loss.detach(), "grads": dict(S.leaves(g)),
                "forward": x, "prefill": pre, "decode": dec,
                "cache": dict(S.leaves(cache))}

    def errors(got, want):
        cat = lambda g: torch.cat([v.reshape(-1) for v in g.values()])
        return {"loss": rel(got["loss"], want["loss"]),
                "grad": rel(cat(got["grads"]), cat(want["grads"])),
                "grads": {k: rel(v, want["grads"][k])
                          for k, v in got["grads"].items()},
                "forward": rel(got["forward"], want["forward"]),
                "prefill": rel(got["prefill"], want["prefill"]),
                "decode": [rel(a, b) for a, b in zip(got["decode"],
                                                      want["decode"])],
                "cache": {k: rel(v, want["cache"][k])
                          for k, v in got["cache"].items()}}

    ref = one_device(params)
    # the one-device port's own spread: its results with every weight
    # one ulp up, one ulp down, and one ulp either way at random
    gen = torch.Generator().manual_seed(0)

    def nudged(a, way):
        if way == 0:
            way = torch.where(torch.rand(a.shape, generator=gen) < 0.5,
                              float("-inf"), float("inf"))
        return torch.nextafter(a, torch.as_tensor(way, dtype=a.dtype))
    spread = [errors(one_device(S.tree_map(
        lambda a: nudged(a, way), params)), ref)
        for way in (float("inf"), float("-inf"), 0)]
    for (data_n, model_n), mesh in meshes.items():
        if f"{case['name']}@{data_n}x{model_n}" not in case["keys"]:
            continue
        mm = build_model(cfg.replace(
            spmd_constraints=True,
            mesh_axis_sizes=(("data", data_n), ("model", model_n))))
        names = ("data", "model")
        got = {}
        with C.use_mesh(mesh):
            psh = TS.param_shardings(mm, mesh, rules)
            lp = shard_params(params, psh)
            bspec = TS.batch_pspec(rules)
            lb = {k: C.local_of(v, bspec) for k, v in batch.items()}
            log.clear()
            share, grads = TS.value_and_grad(mm.loss_fn)(lp, lb)
            grads = TS._grad_constraint(grads, TS.storage_pspecs(mm))
            train_log = list(log)
            got["loss"] = C.psum(share.detach(), names)
            got["grads"] = {k: full(g, sh.spec) for (k, g), (_, sh) in
                            zip(S.leaves(grads), S.leaves(psh))}
            shape = ShapeConfig("tiny", cap, tokens.shape[0], "decode")
            bsh = TS.batch_shardings(mm, shape, mesh, rules)
            specs = S.tree_map(lambda sh: sh.spec, bsh["cache"])
            tspec = bsh["tokens"].spec
            tok = C.local_of(tokens, tspec)
            with torch.no_grad():
                log.clear()
                x, _, _ = T.forward(mm.cfg, lp, lb)
                got["forward"] = full(x, bspec + (None,))
                pre, caches = mm.prefill(lp, {"tokens": tok[:, :P]})
                cache = mm.cache_from_prefill(caches, P, cap)
                got["prefill"] = full(pre, tspec)
                got["decode"] = []
                for t in range(steps):
                    lg, cache = mm.decode(lp, cache,
                                          tok[:, P + t:P + t + 1], P + t,
                                          specs)
                    got["decode"].append(full(lg, tspec))
                serve_log = list(log)
                got["cache"] = {k: full(v, ps) for (k, v), (_, ps) in
                                zip(S.leaves(cache), S.leaves(specs))}
        key = f"{case['name']}@{data_n}x{model_n}"
        if rank == 0:
            np.savez(f"{work}/{key}.npz", loss=got["loss"].numpy(),
                     forward=got["forward"].numpy(),
                     prefill=got["prefill"].numpy(),
                     **{f"decode/{i}": v.numpy()
                        for i, v in enumerate(got["decode"])},
                     **{f"grads/{k}": v.detach().numpy()
                        for k, v in got["grads"].items()},
                     **{f"cache/{k}": v.numpy()
                        for k, v in got["cache"].items()})
        res = {"errors": errors(got, ref), "spread": spread}
        res["partitioned"] = {k: T.mixer_partitioned(mm.cfg, k)
                              for k in ("rwkv", "channelmix", "mamba")}
        res["model_gathers"] = {
            w: [s for k, a, s in lg if k == "all_gather" and a == "model"]
            for w, lg in (("train", train_log), ("serve", serve_log))}
        res["model_exchanges"] = sum(1 for k, a, _ in train_log + serve_log
                                     if k == "all_to_all" and a == "model")
        res["state_shapes"] = sorted({str(list(v.shape)) for n, v in
                                      S.leaves(cache) if n.split("/")[-1]
                                      in ("s", "ssm", "conv")})
        out[key] = res
if rank == 0:
    print("MIXERS " + json.dumps(out))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _reference_model(name):
    """The reference's smoke config, model and parameters (cast to f32)
    of a case."""
    arch, over = CASES[name]
    jcfg = jsmoke(jget_arch(arch)).replace(**over)
    jm = jbuild_model(jcfg)
    return jcfg, jm, jax.tree.map(lambda a: a.astype(jnp.float32),
                                  jm.init(jax.random.key(0)))


def _reference(tmp_path, name):
    """The reference's one-device results on the fixture's tokens: the
    loss and every gradient leaf, the forward, the prefill's logits, each
    decode step's and the last cache's leaves; where ``SPREAD`` names the
    case, also its own spread (its results with every weight one ulp up,
    one ulp down and one ulp either way at random, as errors from its
    own)."""
    jcfg, jm, jp = _reference_model(name)
    data = np.load(tmp_path / "tokens.npz")
    batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
    tokens = jnp.asarray(data["serve"])
    value_and_grad = jax.jit(jax.value_and_grad(jm.loss_fn))
    forward = jax.jit(lambda p: JT.forward(jcfg, p, batch)[0])
    prefill = jax.jit(lambda p: jm.prefill(p, {"tokens": tokens[:, :PROMPT]}))
    decode = jax.jit(jm.decode)

    def run(params):
        loss, grads = value_and_grad(params, batch)
        logits, caches = prefill(params)
        cache = jm.cache_from_prefill(caches, PROMPT, PROMPT + STEPS)
        dec = []
        for t in range(STEPS):
            lg, cache = decode(params, cache,
                               tokens[:, PROMPT + t:PROMPT + t + 1],
                               jnp.int32(PROMPT + t))
            dec.append(np.asarray(lg))
        return {"loss": np.asarray(loss), "grads": _flat(grads),
                "forward": np.asarray(forward(params)),
                "prefill": np.asarray(logits), "decode": dec,
                "cache": _flat(cache)}

    want = run(jp)
    spread = []
    if name in SPREAD:
        rng = np.random.default_rng(0)
        for way in (np.inf, -np.inf, 0):
            def nudged(a):
                to = way or np.where(rng.random(a.shape) < 0.5, -np.inf,
                                     np.inf)
                return jnp.asarray(np.nextafter(np.asarray(a),
                                                np.float32(to)))
            spread.append(_errors(run(jax.tree.map(nudged, jp)), want))
    return want, spread


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _errors(got, want):
    """Relative L2 of each quantity, each gradient and cache leaf on its
    own."""
    cat = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(g)])
    return {"loss": _rel(got["loss"], want["loss"]),
            "grad": _rel(cat(got["grads"]), cat(want["grads"])),
            "grads": {k: _rel(v, want["grads"][k])
                      for k, v in got["grads"].items()},
            "forward": _rel(got["forward"], want["forward"]),
            "prefill": _rel(got["prefill"], want["prefill"]),
            "decode": [_rel(a, b) for a, b in zip(got["decode"],
                                                   want["decode"])],
            "cache": {k: _rel(v, want["cache"][k])
                      for k, v in got["cache"].items()}}


@pytest.fixture(scope="module")
def mixers(tmp_path_factory):
    """Every case of the mesh run (one torchrun of 4 ranks), and the
    reference's one-device results, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("mixers")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, (BATCH, SEQ + 1), dtype=np.int32)
    np.savez(tmp / "tokens.npz", tokens=tokens[:, :-1],
             labels=tokens[:, 1:],
             serve=rng.integers(0, 256, (BATCH, PROMPT + STEPS),
                                dtype=np.int32),
             prompt=PROMPT, steps=STEPS)
    for name in CASES:
        np.savez(tmp / f"{name}.npz", **_flat(_reference_model(name)[2]))
    cases = [{"name": n, "arch": a, "over": o,
              "keys": [k for k in KEYS if k.split("@")[0] == n]}
             for n, (a, o) in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_torchrun, tmp, WORKER, 4, tmp,
                            json.dumps(cases))
        reference = {name: _reference(tmp, name) for name in CASES}
        proc = ranks.result()
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("MIXERS "))
    out = json.loads(line[len("MIXERS "):])
    for key, r in out.items():
        got = dict(np.load(tmp / f"{key}.npz"))
        r["mesh"] = {
            "loss": got["loss"], "forward": got["forward"],
            "prefill": got["prefill"],
            "decode": [got[f"decode/{i}"] for i in range(STEPS)],
            **{part: {k[len(part) + 1:]: v for k, v in got.items()
                      if k.startswith(part + "/")}
               for part in ("grads", "cache")}}
        r["reference"] = reference[key.split("@")[0]]
    return out


#: the 16-layer smoke Jamba runs on (2, 2) only: its bounds come from
#: its spread, and (1, 2) is held on the two-layer cut
KEYS = ["rwkv@1x2", "jamba-2@1x2", "rwkv-odd@1x2",
        "rwkv@2x2", "jamba@2x2", "jamba-2@2x2"]
#: the case whose gradient is held against the reference within the two
#: models' own spreads
SPREAD = {"jamba"}


def _bounds(tol, err, *spreads):
    """Each quantity's bound, the shape of ``err``: ``tol``, or twice the
    one-device model's own spread (the largest move of its result with
    every weight one ulp up, one ulp down, or one ulp either way at
    random) where that is the larger."""
    if isinstance(err, dict):
        return {k: _bounds(tol, v, *(s[k] for s in spreads))
                for k, v in err.items()}
    if isinstance(err, list):
        return [_bounds(tol, v, *(s[i] for s in spreads))
                for i, v in enumerate(err)]
    return max([tol] + [2 * s for s in spreads])


def _over(err, bound, path=""):
    if isinstance(err, dict):
        return [o for k, v in err.items()
                for o in _over(v, bound[k], f"{path}/{k}")]
    if isinstance(err, list):
        return [o for i, v in enumerate(err)
                for o in _over(v, bound[i], f"{path}/{i}")]
    return [] if err <= bound else [(path, err, bound)]


@pytest.mark.parametrize("key", KEYS)
def test_mesh_mixers_match_one_device(mixers, key):
    """The forward, the train step's loss and gradients, the prefill's
    logits, 4 decode steps' logits and every leaf of the final cache,
    against the one-device port.  RWKV-6, the replicated route and the
    smoke Jamba cut to its two Mamba layers (``jamba-2``, the chip's cut)
    hold 1e-5 relative L2 on all of them and on the whole gradient; every
    quantity, each gradient leaf on its own included, holds 1e-5 or twice
    the one-device port's own spread (its result with every weight one
    ulp up, down, or either way at random), the larger.  The smoke Jamba
    of two periods, on the reference's parameters, amplifies any change
    of rounding by ~600 in its forward and ~1e4 in its gradient (its
    forward moves 6e-5 and its gradient 8e-4 for one ulp of the weights),
    so there the spread decides: no partition of its sums could hold it
    closer, the reference's partitioner's neither.
    ``test_mesh_mixers_match_the_reference`` holds the same results
    against the reference."""
    r = mixers[key]
    over = _over(r["errors"], _bounds(TOL, r["errors"], *r["spread"]))
    assert not over, over
    if not key.startswith("jamba@"):
        e = r["errors"]
        strict = [e["loss"], e["grad"], e["forward"], e["prefill"],
                  *e["decode"], *e["cache"].values()]
        assert max(strict) <= TOL, e


@pytest.mark.parametrize("key", KEYS)
def test_mesh_mixers_match_the_reference(mixers, key):
    """The same mesh results against the reference's one-device
    ``value_and_grad``, forward, prefill and decode on the same
    parameters and tokens, at ``test_torch_distributed``'s bounds: the
    loss within 1e-5 relative; the whole gradient, each gradient leaf,
    the forward, each step's logits and each leaf of the final cache
    within 1e-4 relative L2.  The 16-layer smoke Jamba (``jamba@``) holds
    them but on its gradient, which one ulp of its weights moves by
    ~4e-4 in the reference and ~1e-3 in the port (the one-device port is
    1.6e-3 from the reference on ``b1/mamba/dt_bias``): there the whole
    gradient and each leaf hold 1e-4 or twice the larger of the two
    models' own spreads (each one's results with every weight one ulp
    up, down, or either way at random, against its own), whichever is
    larger."""
    r = mixers[key]
    want, ref_spread = r["reference"]
    err = _errors(r["mesh"], want)
    grads = {k: err.pop(k) for k in ("grad", "grads")}
    assert err.pop("loss") <= TOL, r["mesh"]["loss"]
    assert max(_leaves(err)) <= REF_TOL, err
    spreads = [{k: s[k] for k in grads} for s in ref_spread + r["spread"]]
    over = _over(grads, _bounds(REF_TOL, grads, *spreads))
    assert not over, over
    if key.split("@")[0] not in SPREAD:
        assert max(_leaves(grads)) <= REF_TOL, grads


def _leaves(err):
    if isinstance(err, dict):
        return [x for v in err.values() for x in _leaves(v)]
    if isinstance(err, list):
        return [x for v in err for x in _leaves(v)]
    return [err]


@pytest.mark.parametrize("key", KEYS)
def test_no_mixer_weight_or_state_is_gathered_over_the_model_axis(
        mixers, key):
    """On a dividing model axis the mixers run on the rank's share:
    nothing is all-gathered over the model axis in the train step, and in
    the forward, prefill and decode only the logits (the last dim the
    rank's vocabulary shard) are; the recurrent states stay the rank's
    blocks.  Jamba's Mamba ``in_proj`` is exchanged (one all-to-all a
    layer, and its inverse in backward).  On the replicated route (one
    head, an odd d_ff) the mixers' weights are gathered."""
    r = mixers[key]
    M = 2
    name, mesh = key.split("@")
    if name == "jamba-2":
        name = "jamba"
    if name == "rwkv-odd":
        assert not r["partitioned"]["rwkv"]
        assert not r["partitioned"]["channelmix"]
        assert r["model_gathers"]["train"], r
        return
    assert all(r["partitioned"].values()), r
    router = [64, 8 // M]                 # the smoke Jamba's 8 experts
    for what, shapes in r["model_gathers"].items():
        logits = [[len(s) == 2 and s[-1] == 256 // M] for s in shapes]
        assert all(s == router or ok == [True] and what == "serve"
                   for s, ok in zip(shapes, logits)), (what, r)
    if name == "jamba":
        assert r["model_exchanges"] > 0
        want = {"[1, 64, 16]" if mesh == "2x2" else "[2, 64, 16]",
                "[1, 3, 64]" if mesh == "2x2" else "[2, 3, 64]"}
    else:
        assert r["model_exchanges"] == 0
        want = {"[1, 2, 16, 16]" if mesh == "2x2" else "[2, 2, 16, 16]"}
    assert set(r["state_shapes"]) == want, r


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
for arch, over in json.loads(sys.argv[1]).items():
    cfg = smoke_config(get_arch(arch)).replace(
        spmd_constraints=True, mesh_axis_sizes=(("data", 2), ("model", 2)),
        **over)
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
    ma = compiled.memory_analysis()
    out[arch] = {"argument_size_in_bytes": int(ma.argument_size_in_bytes),
                 "flops": DR.analyze_hlo(compiled.as_text())["flops"]}
print(json.dumps(out))
"""

PORT_CELL = """
import json, sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR

out = {}
for arch, over in json.loads(sys.argv[1]).items():
    r = DR.analyze_cell(arch, "train_4k", False,
                        arch_overrides={"microbatches": 1, **over},
                        axis_sizes={"data": 2, "model": 2},
                        shape=ShapeConfig("smoke", 32, 4, "train"),
                        smoke=True)
    out[arch] = {"flops": r["flops"], "memory": r["memory"],
                 "replicated": r.get("replicated_mixer_forward_flops")}
print(json.dumps(out))
"""


#: the reduced cells: the smoke RWKV-6, and the smoke Jamba cut to its
#: two Mamba layers (Mamba + MLP, Mamba + MoE: the chip's cut)
DRY_CELLS = {"rwkv6-1.6b": {},
             "jamba-v0.1-52b": {"attn_layer_period": 2, "n_layers": 2}}


@pytest.fixture(scope="module")
def cells():
    """The reference's and the port's cells, the two processes at once."""
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               json.dumps(DRY_CELLS)],
                              env={**os.environ, "PYTHONPATH": SRC},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for code in (REFERENCE_CELL,
                                                      PORT_CELL)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("arch", sorted(DRY_CELLS))
def test_reduced_recurrent_cells_match_the_reference(cells, arch):
    """The smoke RWKV-6's and the smoke Jamba's (two Mamba layers) train
    step on a (2, 2) layout: the port's per-device argument bytes equal the reference's
    ``memory_analysis()``, its per-device FLOPs are within 5 % of the
    reference's ``analyze_hlo`` with the mixers counted at their share
    (no replicated mixer on this axis), and the peak memory of rank 0's
    step is at least its argument bytes, the temporaries beside them."""
    want, got = cells
    w, g = want[arch], got[arch]
    mem = g["memory"]
    assert mem["argument_size_in_bytes"] == w["argument_size_in_bytes"]
    print(arch, "flops port/reference", g["flops"] / w["flops"])
    assert abs(g["flops"] / w["flops"] - 1) < 0.05, (g["flops"], w["flops"])
    assert not g["replicated"], g["replicated"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] == (mem["peak_memory_in_bytes"]
                                         - mem["argument_size_in_bytes"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_a_recurrent_one_device_step_runs_past_one_scan_chunk(arch):
    """The mesh step's one-device oracle: ``make_train_step`` on a
    recurrent model without remat over 300 tokens, more than one chunk of
    ``chunked_scan``, which checkpoints each chunk.  Its gradient is
    autograd's (``torch.func`` refuses the checkpoint's saved-tensor
    hooks, as under remat), and its loss is the forward's."""
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import optim as O
    from repro_torch.train import train_step as TS

    cfg = smoke_config(get_arch(arch)).replace(remat=False,
                                               n_layers=2,
                                               attn_layer_period=2)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (1, 300), generator=g)
             for k in ("tokens", "labels")}
    opt = O.AdamWConfig()
    step = TS.make_train_step(m, opt)
    _, _, met = step(p, O.adamw_init(opt, p), batch)
    with torch.no_grad():
        want = m.loss_fn(p, batch)
    assert not step.one_graph
    torch.testing.assert_close(met["loss"], want)
    assert torch.isfinite(met["grad_norm"])
