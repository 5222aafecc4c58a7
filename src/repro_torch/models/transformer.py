"""Block assembly and the generic LM: spec building, the forward over the
stacked periods, the chunked LM loss, prefill and decode.

Counterpart of ``repro.models.transformer`` for the ``dense`` and ``moe``
families.  A period is the repeating unit of the architecture (one block
for these families); period parameters are stacked on a leading
``layers`` axis, as in the reference, and ``forward`` loops over the
stack where the reference scans it.  With ``cfg.remat`` each period runs
under ``torch.utils.checkpoint`` (non-reentrant), whose backward replays
the period's forward.  Decode carries a per-layer KV cache
(``init_cache``) through ``decode_step``, a loop over the layers with one
cache entry each, as the reference unrolls it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.spec import ParamSpec, tree_map

F32 = torch.float32


# ---------------------------------------------------------------------------
# Pattern: which blocks make up one period
# ---------------------------------------------------------------------------

def arch_pattern(cfg) -> List[Tuple[str, str]]:
    """[(mixer_kind, ffn_kind)] per layer within one period."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and moe are)")
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
    if mixer != "attn":
        raise ValueError(mixer)
    spec["attn"] = L.attention_spec(d, cfg.n_heads, cfg.n_kv_heads,
                                    d // cfg.n_heads)
    spec["ln2"] = _norm_spec(cfg)
    if ffn == "mlp":
        spec["mlp"] = L.mlp_spec(d, cfg.d_ff)
    elif ffn == "moe":
        spec["moe"] = L.moe_param_spec(d, cfg.d_ff, cfg.moe_experts)
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
    return {
        "blocks": _stack_spec(period_spec, n_periods(cfg)),
        "final_norm": _norm_spec(cfg),
        "unembed": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
    }


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _norm_apply(cfg, p, x):
    _, fn = L.make_norm(cfg.norm, cfg.d_model)
    return fn(p, x)


def apply_block(cfg, bp, x, *, mixer: str, ffn: str, positions,
                moe_impl: Optional[str] = None):
    """Full-sequence block application.  Returns (x, aux_loss,
    cache_entry): the block's k and v in ``x.dtype``."""
    h = _norm_apply(cfg, bp["ln1"], x)
    if mixer != "attn":
        raise ValueError(mixer)
    out, k, v = L.attention_block(bp["attn"], h, positions=positions,
                                  kv_chunk=cfg.kv_chunk, with_kv=True)
    x = x + out
    cache_entry = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp":
        x = x + L.mlp_block(bp["mlp"], h)
    elif ffn == "moe":
        out, aux = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                               impl=moe_impl or cfg.moe_impl)
        x = x + out
    else:
        raise ValueError(ffn)
    return x, aux, cache_entry


def forward(cfg, params, inputs: Dict[str, Any], *,
            collect_cache: bool = False):
    """Full-sequence forward (training / prefill).

    inputs: {"tokens": (B,S) int}, optional "positions" (B,S).
    Returns (x_final (B,S,D), aux_loss, cache or None): with
    ``collect_cache`` each block's k and v stacked over the periods,
    ``{"b0": {"k": (periods, B, S, KV, dh), "v": ...}}``."""
    pattern = arch_pattern(cfg)
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
    """Per-layer cache ``{"p{j}": {"b{i}": {"k", "v"}}}`` of zeros, each
    (B, max_seq, KV, dh) in ``cfg.cache_dtype``, with no stacked periods
    axis: each layer's buffer is its own tensor, as in the reference.
    Only attention mixers have entries here; the recurrent families come
    with their models."""
    hd = cfg.d_model // cfg.n_heads
    shape = (B, max_seq, cfg.n_kv_heads, hd)
    cache: Dict[str, Any] = {}
    for j in range(n_periods(cfg)):
        cache[f"p{j}"] = {
            f"b{i}": {"k": torch.zeros(shape, dtype=cfg.cache_dtype,
                                       device=device),
                      "v": torch.zeros(shape, dtype=cfg.cache_dtype,
                                       device=device)}
            for i, _ in enumerate(arch_pattern(cfg))}
    return cache


def decode_block(cfg, bp, x, ce, pos, *, mixer: str, ffn: str):
    """One decode block against its own per-layer cache entry.  Returns
    (x, new_entry)."""
    if mixer != "attn":
        raise ValueError(mixer)
    h = _norm_apply(cfg, bp["ln1"], x)
    out, kc, vc = L.attention_decode_stacked(bp["attn"], h, ce["k"],
                                             ce["v"], pos)
    x = x + out
    h = _norm_apply(cfg, bp["ln2"], x)
    if ffn == "mlp":
        x = x + L.mlp_block(bp["mlp"], h)
    elif ffn == "moe":
        out, _ = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                             impl=cfg.moe_decode_impl)
        x = x + out
    else:
        raise ValueError(ffn)
    return x, {**ce, "k": kc, "v": vc}


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
