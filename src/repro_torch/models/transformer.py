"""Block assembly and the generic LM: spec building, the forward over the
stacked periods, the chunked LM loss, prefill and decode.

Counterpart of ``repro.models.transformer`` for every family of the
reference: ``dense`` and ``moe`` transformers, ``ssm`` (RWKV-6),
``hybrid`` (Jamba: Mamba and attention mixers, MoE on every
``moe_layer_period``-th layer), and the ``audio`` (HuBERT, bidirectional
attention) and ``vlm`` (InternVL2) transformers behind a stub frontend,
which take precomputed embeddings (``inputs["embeds"]``).  A period is
the repeating unit of the architecture (one block, or Jamba's eight);
period parameters are stacked on a leading ``layers`` axis, as in the
reference, and ``forward`` loops over the stack where the reference
scans it.  With ``cfg.remat`` each period runs under
``torch.utils.checkpoint`` (non-reentrant), whose backward replays the
period's forward.  Decode carries a per-layer cache (``init_cache``: an
attention layer's k/v, a Mamba layer's f32 state and conv tail, an RWKV
layer's (dh, dh) f32 state per head and its two token-shift carries)
through ``decode_step``, a loop over the layers with one cache entry
each, as the reference unrolls it.

The mesh path (``cfg.spmd_constraints``, under ``launch.collectives``'
current mesh) runs one rank's share of the same computation on its
batch shard, the reference's constraints made explicit:

  * ``_constrain``: each layer's weights from their storage sharding
    (2-D, FSDP over "data" x TP over "model") to the compute sharding
    (TP only), an all-gather over "data" whose backward reduce-scatters
    the gradient (ZeRO-3);
  * tensor parallelism over "model": attention by heads, the MLP by d_ff,
    the embedding and unembedding by vocab (a masked lookup and a
    vocabulary-parallel log-sum-exp), each a column/row pair whose
    output is reduced over the model axis;
  * expert parallelism: each rank runs its own experts
    (``layers.moe_block``'s ``shard_ctx``), experts zero-padded to a
    multiple of the model axis;
  * sequence parallelism (``_use_sp``): the residual stream is the rank's
    chunk of the sequence between blocks, a block's input all-gathered
    and its output reduce-scattered;
  * the recurrent mixers tensor-parallel over "model", as the
    reference's compute rules split them (``mixer_partitioned``): RWKV-6's
    time mix by heads and its channel mix by d_ff, Mamba by its inner dim
    (``in_proj``'s contiguous storage block exchanged to the rank's x and
    z columns at compute time, ``collectives.pair_halves``), each with its
    recurrent state the rank's block, never gathered (a decode's cache
    entry stays at its partition spec); a mixer that the model axis does
    not divide runs replicated, its weights (and a decode's state)
    gathered over "model".

``Model.loss_fn`` there returns the rank's share of the loss; the shares
sum to the one-device loss (``launch.collectives`` says how gradients
follow).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models import spec as S
from repro_torch.models.spec import ParamSpec, tree_map

F32 = torch.float32


# ---------------------------------------------------------------------------
# Pattern: which blocks make up one period
# ---------------------------------------------------------------------------

def arch_pattern(cfg) -> List[Tuple[str, str]]:
    """[(mixer_kind, ffn_kind)] per layer within one period."""
    if cfg.family == "ssm":                       # rwkv6
        return [("rwkv", "channelmix")]
    if cfg.family == "hybrid":                    # jamba: attn @ idx 4 of 8
        period = cfg.attn_layer_period or 8
        out = []
        for i in range(period):
            mixer = "attn" if i == (cfg.attn_layer_offset or 4) else "mamba"
            ffn = "moe" if (cfg.moe_experts and i % (cfg.moe_layer_period or 2)
                            == 1) else "mlp"
            out.append((mixer, ffn))
        return out
    return [("attn", "moe" if cfg.moe_experts else "mlp")]


def n_periods(cfg) -> int:
    period = len(arch_pattern(cfg))
    assert cfg.n_layers % period == 0, (cfg.n_layers, period)
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# Spec building
# ---------------------------------------------------------------------------

def _norm_spec(cfg):
    s, _ = L.make_norm(cfg.norm, cfg.d_model)
    return s


def block_spec(cfg, mixer: str, ffn: str) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if mixer == "attn":
        spec["attn"] = L.attention_spec(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)
    elif mixer == "mamba":
        spec["mamba"] = M.mamba_spec(d, d_state=cfg.d_state)
    elif mixer == "rwkv":
        spec["tm"] = R.timemix_spec(d, cfg.n_heads)
    else:
        raise ValueError(mixer)
    spec["ln2"] = _norm_spec(cfg)
    if ffn == "mlp":
        spec["mlp"] = L.mlp_spec(d, cfg.d_ff)
    elif ffn == "moe":
        spec["moe"] = L.moe_param_spec(d, cfg.d_ff, cfg.moe_experts)
    elif ffn == "channelmix":
        spec["cm"] = R.channelmix_spec(d, cfg.d_ff)
    else:
        raise ValueError(ffn)
    return spec


def _stack_spec(spec_tree, n: int):
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        dtype=s.dtype, init=s.init,
                                        scale=s.scale), spec_tree)


def model_spec(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    pattern = arch_pattern(cfg)
    period_spec = {f"b{i}": block_spec(cfg, mx, ff)
                   for i, (mx, ff) in enumerate(pattern)}
    spec: Dict[str, Any] = {
        "blocks": _stack_spec(period_spec, n_periods(cfg)),
        "final_norm": _norm_spec(cfg),
        "unembed": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }
    # a stub frontend feeds precomputed embeddings, so an encoder has no
    # table; a vlm's decode still consumes tokens and keeps one
    if cfg.frontend == "none" or cfg.family == "vlm":
        spec["embed"] = ParamSpec((cfg.vocab, d), ("vocab", "embed"))
    return spec


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _norm_apply(cfg, p, x):
    _, fn = L.make_norm(cfg.norm, cfg.d_model)
    return fn(p, x)


# ---------------------------------------------------------------------------
# Distribution: the weights' compute sharding, the mesh context
# ---------------------------------------------------------------------------

def _axis_sizes(cfg) -> Dict[str, int]:
    return dict(cfg.mesh_axis_sizes)


def _storage_rules(sizes):
    return S.MULTI_POD_RULES if "pod" in sizes else S.SINGLE_POD_RULES


def _constrain(cfg, spec_tree, params):
    """Compute-time weights (a no-op unless cfg.spmd_constraints): each
    leaf from its storage partition spec to its compute one, an
    all-gather over "data" of the FSDP dimension whose backward
    reduce-scatters the gradient."""
    if not cfg.spmd_constraints:
        return params
    sizes = _axis_sizes(cfg)
    rules = _storage_rules(sizes)
    return tree_map(lambda sp, v: C.reshard(
        v, S.spec_to_pspec_sizes(sp, sizes, rules),
        S.spec_to_pspec_sizes(sp, sizes, S.COMPUTE_RULES)), spec_tree, params)


def _constrain_leaf(cfg, spec_leaf, value):
    return _constrain(cfg, spec_leaf, value)


def _batch_axes(cfg) -> Tuple[str, ...]:
    sizes = _axis_sizes(cfg)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _use_sp(cfg) -> bool:
    """Sequence-parallel residual stream: the (B, S, D) stream sharded
    over the model axis on S between blocks (turns the TP all-reduces into
    all-gather / reduce-scatter pairs and divides the stream's memory by
    the model axis).  Off for the recurrent mixers (RWKV, Mamba), which
    scan over the whole sequence."""
    return (cfg.spmd_constraints
            and cfg.seq_parallel
            and cfg.family not in ("ssm", "hybrid")
            and _axis_sizes(cfg).get("model", 1) > 1)


def _moe_shard_ctx(cfg, seq: Optional[int] = None):
    """The mesh context of the blocks (None off the mesh); sequence
    parallelism is off for a sequence the model axis does not divide."""
    if not cfg.spmd_constraints:
        return None
    sp = _use_sp(cfg) and (seq is None
                           or seq % _axis_sizes(cfg).get("model", 1) == 0)
    return L.MeshCtx(batch_axes=_batch_axes(cfg), model="model", sp=sp,
                     combine_bf16=cfg.moe_combine_bf16,
                     experts=cfg.moe_experts)


def _sp_constrain(ctx, x):
    """The residual stream, replicated over the model axis, in its layout
    between blocks (the rank's chunk of the sequence under sequence
    parallelism)."""
    return x if ctx is None else ctx.exit(x, partial=False)


def _n_ranks(cfg) -> int:
    return math.prod(_axis_sizes(cfg).values())


def _compute_pspecs(cfg, spec_tree):
    return S.compute_pspecs(spec_tree, _axis_sizes(cfg))


def _without_model(pspec) -> S.PSpec:
    """``pspec`` with the model axis taken out of every entry."""
    return tuple(tuple(a for a in S.pspec_axes(e) if a != "model") or None
                 for e in pspec)


def _replicated_over_model(cfg, spec_tree, params):
    """Compute-time weights gathered over the model axis (a recurrent
    mixer that the model axis does not divide runs replicated on every
    model rank)."""
    return tree_map(lambda ps, v: C.reshard(v, ps, _without_model(ps)),
                    _compute_pspecs(cfg, spec_tree), params)


#: the width each recurrent mixer is split by over the model axis
_SPLIT_BY = {"rwkv": lambda cfg: cfg.n_heads,
             "channelmix": lambda cfg: cfg.d_ff,
             "mamba": lambda cfg: 2 * cfg.d_model}


def mixer_partitioned(cfg, kind: str) -> bool:
    """Whether the model axis divides a recurrent mixer (``rwkv``: its
    heads, ``channelmix``: d_ff, ``mamba``: its inner dim), so that each
    model rank computes its share; otherwise the mixer runs replicated."""
    return _SPLIT_BY[kind](cfg) % _axis_sizes(cfg).get("model", 1) == 0


_SPEC_KEY = {"rwkv": "tm", "mamba": "mamba", "channelmix": "cm"}


def _mixer_weights(cfg, bspec, bp, kind: str):
    """A recurrent mixer's weights as the mesh path computes with them:
    tensor-parallel where the model axis divides it (RWKV's per-head
    vectors cut to the rank's heads; Mamba's ``in_proj``, stored as one
    contiguous ``2·di`` block a rank, exchanged to the rank's x and z
    columns), else gathered to replicated over the model axis."""
    key = _SPEC_KEY[kind]
    p = bp[key]
    if not mixer_partitioned(cfg, kind):
        p = _replicated_over_model(cfg, bspec[key], p)
    elif kind == "rwkv":
        p = dict(p, **{k: C.local_chunk(p[k], "model", 0)
                       for k in ("u", "w_bias", "ln_scale")})
    elif kind == "mamba":
        p = dict(p, in_proj=C.pair_halves(p["in_proj"], "model", 1))
    return dict(bp, **{key: p})


def _mixer_ctx(cfg, ctx, kind: str) -> Dict[str, Any]:
    """The keyword that puts a recurrent mixer on its mesh route: the
    mesh context where it is partitioned, nothing (the one-device
    computation) off the mesh or where it runs replicated."""
    if ctx is not None and mixer_partitioned(cfg, kind):
        return {"shard_ctx": ctx}
    return {}


def _ep_weights(cfg, p):
    """The MoE layer's compute-time weights as the mesh path takes them:
    the whole router, and this rank's experts of the stack zero-padded to
    a multiple of the model axis (granite-moe: 40 -> 48 on 16)."""
    M = _axis_sizes(cfg).get("model", 1)
    E = cfg.moe_experts
    E_pad = -(-E // M) * M
    cps = _compute_pspecs(cfg, L.moe_param_spec(cfg.d_model, cfg.d_ff, E))
    out = {"router": C.reshard(p["router"], cps["router"], (None, None))}
    for k in ("wg", "wu", "wd"):
        w = p[k]
        if E_pad != E or cps[k] != ("model", None, None):
            w = C.reshard(w, cps[k], (None, None, None))
            w = F.pad(w, (0, 0, 0, 0, 0, E_pad - E))
            w = C.local_chunk(w, "model", 0)
        out[k] = w
    return out


def _embed(cfg, ctx, embed, tokens):
    """The token embedding (``F.embedding``, whose backward sums a
    repeated token's rows in f32 on the card before its one rounding to
    the table's dtype: a Zipfian batch repeats its commonest token
    hundreds of times); on the mesh a vocabulary-parallel lookup (the
    rank's rows, other tokens zero, summed over the model axis) in the
    residual stream's layout."""
    tokens = tokens.long()
    if ctx is None:
        return F.embedding(tokens, embed)
    rows = embed.shape[0]
    if rows == cfg.vocab:
        return _sp_constrain(ctx, F.embedding(tokens, embed))
    t = tokens - C.axis_index(ctx.model) * rows
    ok = (t >= 0) & (t < rows)
    e = torch.where(ok[..., None], F.embedding(t.clamp(0, rows - 1), embed),
                    0)
    return ctx.exit(e, partial=True).to(embed.dtype)


def apply_block(cfg, bp, x, *, mixer: str, ffn: str, positions,
                moe_impl: Optional[str] = None, shard_ctx=None):
    """Full-sequence block application.  Returns (x, aux_loss,
    cache_entry): an attention block's k and v in ``x.dtype``, a Mamba
    block's f32 state ``ssm`` and its conv tail ``conv`` (in ``x.dtype``),
    an RWKV block's state ``s`` after the sequence and its token-shift
    carries ``last_tm`` / ``last_cm``.  With ``shard_ctx`` (the mesh
    path) ``bp`` is at its compute sharding, x is the rank's residual
    stream and an attention cache entry holds the rank's kv heads."""
    if shard_ctx is not None:
        bspec = block_spec(cfg, mixer, ffn)
        if mixer in ("mamba", "rwkv"):
            bp = _mixer_weights(cfg, bspec, bp, mixer)
        if ffn == "channelmix":
            bp = _mixer_weights(cfg, bspec, bp, "channelmix")
        elif ffn == "moe":
            bp = dict(bp, moe=_ep_weights(cfg, bp["moe"]))
    h = _norm_apply(cfg, bp["ln1"], x)
    if mixer == "attn" and shard_ctx is not None:
        out, k, v = L.attention_block_mesh(
            bp["attn"], h, shard_ctx, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, positions=positions, causal=cfg.causal,
            kv_chunk=cfg.kv_chunk, with_kv=True)
        cache_entry = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    elif mixer == "attn":
        out, k, v = L.attention_block(bp["attn"], h, positions=positions,
                                      causal=cfg.causal,
                                      kv_chunk=cfg.kv_chunk, with_kv=True)
        cache_entry = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    elif mixer == "mamba":
        B, di = x.shape[0], bp["mamba"]["in_proj"].shape[1] // 2
        state = (torch.zeros((B, di, cfg.d_state), dtype=F32,
                             device=x.device),
                 torch.zeros((B, M.CONV_K - 1, di), dtype=F32,
                             device=x.device))
        out, (ssm, conv) = M.mamba_block(
            bp["mamba"], h, state, cfg.d_state,
            **_mixer_ctx(cfg, shard_ctx, "mamba"))
        cache_entry = {"ssm": ssm, "conv": conv}
    elif mixer == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        heads = bp["tm"]["wr"].shape[1] // hd        # the rank's heads
        state = torch.zeros((x.shape[0], heads, hd, hd), dtype=F32,
                            device=x.device)
        out, state, last_x = R.timemix(
            bp["tm"], h, state, cfg.n_heads,
            **_mixer_ctx(cfg, shard_ctx, "rwkv"))
        cache_entry = {"s": state, "last_tm": last_x}
    else:
        raise ValueError(mixer)
    x = x + out
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp" and shard_ctx is not None:
        x = x + L.mlp_block_mesh(bp["mlp"], h, shard_ctx, d_ff=cfg.d_ff)
    elif ffn == "mlp":
        x = x + L.mlp_block(bp["mlp"], h)
    elif ffn == "moe":
        out, aux = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                               impl=moe_impl or cfg.moe_impl,
                               capacity_factor=cfg.capacity_factor,
                               shard_ctx=shard_ctx)
        x = x + out
    elif ffn == "channelmix":
        out, cache_entry["last_cm"] = R.channelmix(
            bp["cm"], h, **_mixer_ctx(cfg, shard_ctx, "channelmix"))
        x = x + out
    else:
        raise ValueError(ffn)
    return x, aux, cache_entry


def forward(cfg, params, inputs: Dict[str, Any], *,
            collect_cache: bool = False):
    """Full-sequence forward (training / prefill).

    inputs: {"tokens": (B,S) int} or, for a stub frontend, {"embeds":
    (B,S,D)} (cast to ``cfg.param_dtype``); optional "positions" (B,S).
    Returns (x_final (B,S,D), aux_loss, cache or None): with
    ``collect_cache`` each block's cache entry stacked over the periods,
    ``{"b0": {"k": (periods, B, S, KV, dh), "v": ...}}`` (Mamba:
    ``{"ssm": (periods, B, di, N), "conv": (periods, B, 3, di)}``; RWKV:
    ``{"s": (periods, B, H, dh, dh), "last_tm": (periods, B, D),
    "last_cm": ...}``).  On the mesh each entry is the rank's block: its
    batch rows, its kv heads, a partitioned mixer's state its heads or
    channels (the decode cache's layout, so ``cache_from_prefill`` gives
    the rank's decode cache with no collective)."""
    pattern = arch_pattern(cfg)
    B, Sq = inputs["embeds" if "embeds" in inputs else "tokens"].shape[:2]
    ctx = _moe_shard_ctx(cfg, Sq)
    if "embeds" in inputs:
        x = _sp_constrain(ctx, inputs["embeds"].to(cfg.param_dtype))
    else:
        x = _embed(cfg, ctx, _constrain_leaf(
            cfg, ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
            params["embed"]), inputs["tokens"])
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=x.device)[None].expand(B, Sq)
    period_specs = {f"b{i}": block_spec(cfg, mx, ff)
                    for i, (mx, ff) in enumerate(pattern)}

    def period_fn(x, aux, period_params):
        caches = {}
        for i, (mx, ff) in enumerate(pattern):
            bp = _constrain(cfg, period_specs[f"b{i}"],
                            period_params[f"b{i}"])
            x, a, ce = apply_block(cfg, bp, x, mixer=mx, ffn=ff,
                                   positions=positions, shard_ctx=ctx)
            aux = aux + a
            caches[f"b{i}"] = ce
        return x, aux, caches

    aux = torch.zeros((), dtype=F32, device=x.device)
    per_period = []
    for j in range(n_periods(cfg)):
        period_params = tree_map(lambda a: a[j], params["blocks"])
        if cfg.remat and torch.is_grad_enabled():
            x, aux, caches = checkpoint(period_fn, x, aux, period_params,
                                        use_reentrant=False)
        else:
            x, aux, caches = period_fn(x, aux, period_params)
        if collect_cache:
            per_period.append(caches)
    caches = (tree_map(lambda *a: torch.stack(a), *per_period)
              if collect_cache else None)
    return _norm_apply(cfg, params["final_norm"], x), aux, caches


# ---------------------------------------------------------------------------
# Chunked LM loss (the (B, S, V) logits never exist)
# ---------------------------------------------------------------------------

def lm_loss(cfg, params, x_final, labels, *, chunk: int = 512):
    """Cross-entropy over the vocab in sequence chunks, so at most (B,
    chunk, V) logits live at once; mask = labels >= 0.

    On the mesh ``x_final`` is the rank's residual stream, its rows the
    batch shard whose ``labels`` these are; the logits are the rank's
    vocabulary shard (a log-sum-exp and the label's logit summed over the
    model axis), and the result is the rank's share: its rows' summed
    loss over the global label count and the model axis's size, so that
    the shares of all ranks sum to the one-device loss."""
    ctx = _moe_shard_ctx(cfg, labels.shape[1])
    if ctx is not None:
        x_final = ctx.enter(x_final)
    B, Sq, D = x_final.shape
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        x_final = F.pad(x_final, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    unembed = _constrain_leaf(
        cfg, ParamSpec((D, cfg.vocab), ("embed", "vocab")),
        params["unembed"]).float()
    vocab_shard = unembed.shape[1] < cfg.vocab
    tot = torch.zeros((), dtype=F32, device=x_final.device)
    cnt = torch.zeros((), dtype=F32, device=x_final.device)
    for c in range(x_final.shape[1] // chunk):
        xck = x_final[:, c * chunk:(c + 1) * chunk]
        lck = labels[:, c * chunk:(c + 1) * chunk].long()
        logits = torch.einsum("bsd,dv->bsv", xck.float(), unembed)
        if vocab_shard:
            lse, picked = _vocab_parallel_terms(ctx, logits, lck)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1,
                                  torch.clamp_min(lck, 0)[..., None])[..., 0]
        mask = (lck >= 0).float()
        tot = tot + torch.sum((lse - picked) * mask)
        cnt = cnt + torch.sum(mask)
    if ctx is None:
        return tot / torch.clamp_min(cnt, 1.0)
    cnt = C.psum(cnt, ctx.batch_axes)
    return tot / torch.clamp_min(cnt, 1.0) / C.axis_size(ctx.model)


def _vocab_parallel_terms(ctx, logits, labels):
    """log-sum-exp over the whole vocabulary and each label's logit, from
    the rank's vocabulary shard of the logits (both summed over the model
    axis)."""
    rows = logits.shape[-1]
    mx = C.pmax(logits.amax(-1), ctx.model)
    lse = torch.log(C.psum(torch.exp(logits - mx[..., None]).sum(-1),
                           ctx.model)) + mx
    t = labels - C.axis_index(ctx.model) * rows
    ok = (t >= 0) & (t < rows)
    mine = torch.gather(logits, -1, t.clamp(0, rows - 1)[..., None])[..., 0]
    return lse, C.psum(torch.where(ok, mine, 0), ctx.model)


def lm_logits_last(cfg, params, x_final, seq: Optional[int] = None):
    """Logits of the last position only (prefill -> first generated
    token), in f32; on the mesh (``seq``: the prefill's length) every
    rank gets the whole row."""
    ctx = _moe_shard_ctx(cfg, seq)
    unembed = params["unembed"]
    if ctx is None:
        return torch.einsum("bd,dv->bv", x_final[:, -1, :].float(),
                            unembed.float())
    unembed = _constrain_leaf(
        cfg, ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
        unembed)
    last = ctx.enter(x_final)[:, -1, :]
    logits = torch.einsum("bd,dv->bv", last.float(), unembed.float())
    if unembed.shape[1] < cfg.vocab:
        logits = C.all_gather(logits, ctx.model, 1)
    return logits


# ---------------------------------------------------------------------------
# Decode (one new token, the cache carried)
# ---------------------------------------------------------------------------

def init_cache(cfg, B: int, max_seq: int, device=None) -> Dict[str, Any]:
    """Per-layer cache ``{"p{j}": {"b{i}": entries}}`` of zeros with no
    stacked periods axis: each layer's buffer is its own tensor, as in the
    reference.  An attention block's ``k`` / ``v`` are (B, max_seq, KV,
    dh) in ``cfg.cache_dtype``; a Mamba block's state ``ssm`` is (B, di,
    N) f32 and its conv tail ``conv`` (B, 3, di) f32, di = 2 d_model; an
    RWKV block's state ``s`` is (B, H, dh, dh) f32 and its carries
    ``last_tm`` / ``last_cm`` (B, D) in ``cfg.param_dtype``; the last two
    kinds at any ``max_seq``."""
    hd = cfg.resolved_head_dim
    di = 2 * cfg.d_model

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Dict[str, Any] = {}
    for j in range(n_periods(cfg)):
        period = {}
        for i, (mx, ff) in enumerate(arch_pattern(cfg)):
            ce: Dict[str, Any] = {}
            if mx == "attn":
                shape = (B, max_seq, cfg.n_kv_heads, hd)
                ce = {"k": zeros(shape, cfg.cache_dtype),
                      "v": zeros(shape, cfg.cache_dtype)}
            elif mx == "mamba":
                ce = {"ssm": zeros((B, di, cfg.d_state), F32),
                      "conv": zeros((B, M.CONV_K - 1, di), F32)}
            elif mx == "rwkv":
                ce = {"s": zeros((B, cfg.n_heads, hd, hd), F32),
                      "last_tm": zeros((B, cfg.d_model), cfg.param_dtype)}
            if ff == "channelmix":
                ce["last_cm"] = zeros((B, cfg.d_model), cfg.param_dtype)
            period[f"b{i}"] = ce
        cache[f"p{j}"] = period
    return cache


def decode_block(cfg, bp, x, ce, pos, *, mixer: str, ffn: str):
    """One decode block against its own per-layer cache entry.  Returns
    (x, new_entry)."""
    h = _norm_apply(cfg, bp["ln1"], x)
    new_ce = dict(ce)
    if mixer == "attn":
        out, new_ce["k"], new_ce["v"] = L.attention_decode_stacked(
            bp["attn"], h, ce["k"], ce["v"], pos)
    elif mixer == "mamba":
        # the conv tail stays in the cache's dtype (exact: it holds
        # activations), so a decode step's signature is the same at every
        # step; the reference returns it in the activations' dtype
        out, (new_ce["ssm"], conv) = M.mamba_block(
            bp["mamba"], h, (ce["ssm"], ce["conv"]), cfg.d_state)
        new_ce["conv"] = conv.to(ce["conv"].dtype)
    elif mixer == "rwkv":
        out, new_ce["s"], last = R.timemix(bp["tm"], h, ce["s"], cfg.n_heads,
                                           x_prev=ce["last_tm"])
        new_ce["last_tm"] = last.to(ce["last_tm"].dtype)
    else:
        raise ValueError(mixer)
    x = x + out
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp":
        x = x + L.mlp_block(bp["mlp"], h)
    elif ffn == "moe":
        out, _ = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                             impl=cfg.moe_decode_impl)
        x = x + out
    elif ffn == "channelmix":
        out, last = R.channelmix(bp["cm"], h, x_prev=ce["last_cm"])
        x = x + out
        new_ce["last_cm"] = last.to(ce["last_cm"].dtype)
    else:
        raise ValueError(ffn)
    return x, new_ce


def _decode_block_mesh(cfg, bp, x, ce, pos, specs, ctx, *, mixer: str,
                       ffn: str):
    """``decode_block`` on the mesh: ``bp`` at its compute sharding, ``ce``
    the rank's blocks of the cache entry at ``specs`` (a partition spec by
    leaf name, ``train_step.batch_shardings``' rules).  A partitioned
    recurrent mixer computes on the rank's block of its state (its heads
    or channels), which stays where it is; one that the model axis does
    not divide has its state gathered over the model axis, computed
    replicated and cut back to the rank's block."""
    bspec = block_spec(cfg, mixer, ffn)
    gather = mixer in ("mamba", "rwkv") and not mixer_partitioned(cfg, mixer)
    run = {n: _without_model(ps) if gather else ps
           for n, ps in specs.items()}
    state = {n: C.reshard(v, specs[n], run[n]) for n, v in ce.items()
             if n not in ("k", "v")}
    if mixer in ("mamba", "rwkv"):
        bp = _mixer_weights(cfg, bspec, bp, mixer)
    if ffn == "channelmix":
        bp = _mixer_weights(cfg, bspec, bp, "channelmix")
    elif ffn == "moe":
        bp = dict(bp, moe=_ep_weights(cfg, bp["moe"]))
    h = _norm_apply(cfg, bp["ln1"], x)
    new = {}
    if mixer == "attn":
        out, new["k"], new["v"] = L.attention_decode_mesh(
            bp["attn"], h, ce["k"], ce["v"], pos, ctx, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, seq_axes=S.pspec_axes(specs["k"][1]))
    elif mixer == "mamba":
        out, (new["ssm"], conv) = M.mamba_block(
            bp["mamba"], h, (state["ssm"], state["conv"]), cfg.d_state,
            **_mixer_ctx(cfg, ctx, "mamba"))
        new["conv"] = conv.to(ce["conv"].dtype)
    else:
        out, new["s"], last = R.timemix(
            bp["tm"], h, state["s"], cfg.n_heads, x_prev=state["last_tm"],
            **_mixer_ctx(cfg, ctx, "rwkv"))
        new["last_tm"] = last.to(ce["last_tm"].dtype)
    x = x + out
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp":
        x = x + L.mlp_block_mesh(bp["mlp"], h, ctx, d_ff=cfg.d_ff)
    elif ffn == "moe":
        out, _ = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                             impl=cfg.moe_decode_impl,
                             capacity_factor=cfg.capacity_factor,
                             shard_ctx=ctx)
        x = x + out
    else:
        out, last = R.channelmix(bp["cm"], h, x_prev=state["last_cm"],
                                 **_mixer_ctx(cfg, ctx, "channelmix"))
        x = x + out
        new["last_cm"] = last.to(ce["last_cm"].dtype)
    return x, {n: v if n in ("k", "v") else C.reshard(v, run[n], specs[n])
               for n, v in new.items()}


def decode_step(cfg, params, cache, tokens, pos, cache_specs=None):
    """tokens: (B, 1) int; pos: a scalar (the whole batch at one write
    position) or (B,) (per-slot positions: continuous batching).
    Returns (logits (B, V) f32, new_cache).

    The loop over the periods is unrolled, each layer's parameters a
    slice of the stack and its cache entry its own buffer, as in the
    reference.  On the mesh ``cache`` holds the rank's blocks at
    ``cache_specs`` (the cache's partition-spec tree) and every rank gets
    the whole logits row of its tokens."""
    if cfg.spmd_constraints:
        return _decode_step_mesh(cfg, params, cache, tokens, pos,
                                 cache_specs)
    pattern = arch_pattern(cfg)
    x = params["embed"][tokens.long()]
    new_cache: Dict[str, Any] = {}
    for j in range(n_periods(cfg)):
        period_params = tree_map(lambda a: a[j], params["blocks"])
        new_period = {}
        for i, (mx, ff) in enumerate(pattern):
            x, new_period[f"b{i}"] = decode_block(
                cfg, period_params[f"b{i}"], x, cache[f"p{j}"][f"b{i}"],
                pos, mixer=mx, ffn=ff)
        new_cache[f"p{j}"] = new_period
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = torch.einsum("bd,dv->bv", x[:, 0].float(),
                          params["unembed"].float())
    return logits, new_cache


def _decode_step_mesh(cfg, params, cache, tokens, pos, cache_specs):
    ctx = _moe_shard_ctx(cfg)._replace(sp=False)
    pattern = arch_pattern(cfg)
    x = _embed(cfg, ctx, _constrain_leaf(
        cfg, ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        params["embed"]), tokens)
    period_specs = {f"b{i}": block_spec(cfg, mx, ff)
                    for i, (mx, ff) in enumerate(pattern)}
    new_cache: Dict[str, Any] = {}
    for j in range(n_periods(cfg)):
        period_params = tree_map(lambda a: a[j], params["blocks"])
        new_period = {}
        for i, (mx, ff) in enumerate(pattern):
            key = f"b{i}"
            bp = _constrain(cfg, period_specs[key], period_params[key])
            x, new_period[key] = _decode_block_mesh(
                cfg, bp, x, cache[f"p{j}"][key], pos,
                cache_specs[f"p{j}"][key], ctx, mixer=mx, ffn=ff)
        new_cache[f"p{j}"] = new_period
    x = _norm_apply(cfg, params["final_norm"], x)
    unembed = _constrain_leaf(
        cfg, ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
        params["unembed"])
    logits = torch.einsum("bd,dv->bv", x[:, 0].float(), unembed.float())
    if unembed.shape[1] < cfg.vocab:
        logits = C.all_gather(logits, ctx.model, 1)
    return logits, new_cache
