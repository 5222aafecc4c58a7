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
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
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


def apply_block(cfg, bp, x, *, mixer: str, ffn: str, positions,
                moe_impl: Optional[str] = None):
    """Full-sequence block application.  Returns (x, aux_loss,
    cache_entry): an attention block's k and v in ``x.dtype``, a Mamba
    block's f32 state ``ssm`` and its conv tail ``conv`` (in ``x.dtype``),
    an RWKV block's state ``s`` after the sequence and its token-shift
    carries ``last_tm`` / ``last_cm``."""
    h = _norm_apply(cfg, bp["ln1"], x)
    if mixer == "attn":
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
        out, (ssm, conv) = M.mamba_block(bp["mamba"], h, state, cfg.d_state)
        cache_entry = {"ssm": ssm, "conv": conv}
    elif mixer == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        state = torch.zeros((x.shape[0], cfg.n_heads, hd, hd), dtype=F32,
                            device=x.device)
        out, state, last_x = R.timemix(bp["tm"], h, state, cfg.n_heads)
        cache_entry = {"s": state, "last_tm": last_x}
    else:
        raise ValueError(mixer)
    x = x + out
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp":
        x = x + L.mlp_block(bp["mlp"], h)
    elif ffn == "moe":
        out, aux = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                               impl=moe_impl or cfg.moe_impl)
        x = x + out
    elif ffn == "channelmix":
        out, cache_entry["last_cm"] = R.channelmix(bp["cm"], h)
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
    "last_cm": ...}``)."""
    pattern = arch_pattern(cfg)
    if "embeds" in inputs:
        x = inputs["embeds"].to(cfg.param_dtype)
    else:
        x = params["embed"][inputs["tokens"].long()]
    B, S = x.shape[0], x.shape[1]
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)

    def period_fn(x, aux, period_params):
        caches = {}
        for i, (mx, ff) in enumerate(pattern):
            x, a, ce = apply_block(cfg, period_params[f"b{i}"], x, mixer=mx,
                                   ffn=ff, positions=positions)
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
    chunk, V) logits live at once; mask = labels >= 0."""
    B, S, D = x_final.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x_final = F.pad(x_final, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    unembed = params["unembed"].float()
    tot = torch.zeros((), dtype=F32, device=x_final.device)
    cnt = torch.zeros((), dtype=F32, device=x_final.device)
    for c in range(x_final.shape[1] // chunk):
        xck = x_final[:, c * chunk:(c + 1) * chunk]
        lck = labels[:, c * chunk:(c + 1) * chunk].long()
        logits = torch.einsum("bsd,dv->bsv", xck.float(), unembed)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              torch.clamp_min(lck, 0)[..., None])[..., 0]
        mask = (lck >= 0).float()
        tot = tot + torch.sum((lse - picked) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp_min(cnt, 1.0)


def lm_logits_last(cfg, params, x_final):
    """Logits of the last position only (prefill -> first generated
    token), in f32."""
    return torch.einsum("bd,dv->bv", x_final[:, -1, :].float(),
                        params["unembed"].float())


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


def decode_step(cfg, params, cache, tokens, pos):
    """tokens: (B, 1) int; pos: a scalar (the whole batch at one write
    position) or (B,) (per-slot positions: continuous batching).
    Returns (logits (B, V) f32, new_cache).

    The loop over the periods is unrolled, each layer's parameters a
    slice of the stack and its cache entry its own buffer, as in the
    reference."""
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
