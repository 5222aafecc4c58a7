"""Shared layers: norms, rotary embedding, GQA attention, the SwiGLU MLP
and the MoE expert FFN (naive dense dispatch, the same passed through
LiLAC, and the capacity-bucket grouped dispatch).

Counterpart of ``repro.models.layers``, with the one-token decode
against a KV cache (``attention_decode_stacked``), the flat MoE
formulations of the decode step, and the chunked scan over time of the
recurrent mixers (``chunked_scan``).  All functions are pure; parameters
are dicts of tensors built from the ``*_spec`` trees
(``models.spec.ParamSpec``).  A product of an activation and a weight
runs at their promoted dtype (``promoted_einsum``), as JAX promotes: a
stub frontend's f32 embeddings against bf16 weights compute in f32.  ``moe_spec`` /
``moe_params`` are the MoE layer's own (shape, dtype) table and its
seeded draw, which the kernel tests and ``chip_smoke.py`` use;
``moe_params_from_numpy`` takes the JAX package's parameters as numpy
arrays.  ``chunked_attention`` is the reference's online softmax over kv
chunks as a plain loop (not ``scaled_dot_product_attention``), so that
it computes the reference's sums, causal or (an encoder's) bidirectional.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.harness import one_hot
from repro_torch.launch import collectives as C
from repro_torch.models.spec import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), (None,), init="ones", dtype=F32)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def nonparam_layernorm(x, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def promoted_einsum(eq: str, *operands):
    """``torch.einsum`` at the operands' promoted dtype (JAX's rule for a
    product of mixed dtypes; operands of one dtype are passed as they
    are)."""
    dt = operands[0].dtype
    for a in operands[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return torch.einsum(eq, *(a.to(dt) for a in operands))


def chunked_scan(step, init, xs, chunk: int = 128):
    """The reference's rematerialized ``lax.scan`` as a loop over time:
    ``step(carry, x_t) -> (carry, y_t)`` over the leading axis of each
    tensor of the tuple ``xs``; returns (carry, the y_t stacked).  With
    grad on and more than ``chunk`` steps, each chunk runs under
    ``torch.utils.checkpoint`` (non-reentrant), so backward keeps the
    carries at chunk boundaries only and replays each chunk's forward:
    O(S/chunk) carries instead of O(S).  Where nothing requires grad
    (inference) the loop runs plain."""
    def run(carry, *part):
        ys = []
        for t in range(part[0].shape[0]):
            carry, y = step(carry, tuple(a[t] for a in part))
            ys.append(y)
        return carry, torch.stack(ys)

    S = xs[0].shape[0]
    grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in (init, *xs))
    if S <= chunk or not grad:
        return run(init, *xs)
    carry, ys = init, []
    for s0 in range(0, S, chunk):
        carry, y = checkpoint(run, carry, *(a[s0:s0 + chunk] for a in xs),
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


def make_norm(kind: str, d: int):
    if kind == "rmsnorm":
        return rmsnorm_spec(d), rmsnorm
    if kind == "layernorm_nonparam":
        return {}, lambda p, x: nonparam_layernorm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    angles = positions[..., None].float() * freqs           # (..., S, half)
    angles = angles[..., None, :]                           # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rest = x[..., 2 * half:]
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), rest], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention (online softmax over kv chunks)
# ---------------------------------------------------------------------------

def attention_spec(d_model: int, n_heads: int, n_kv: int,
                   head_dim: int) -> Dict[str, ParamSpec]:
    return {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", None)),
        "wk": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", None, "embed")),
    }


def _qkv(p, x, positions):
    q = promoted_einsum("bsd,dhk->bshk", x, p["wq"])
    k = promoted_einsum("bsd,dhk->bshk", x, p["wk"])
    v = promoted_einsum("bsd,dhk->bshk", x, p["wv"])
    return rope(q, positions), rope(k, positions), v


def chunked_attention(q, k, v, *, causal: bool = True, kv_chunk: int = 1024,
                      q_positions=None, kv_positions=None):
    """Memory-efficient attention: a loop over kv chunks carrying the
    running (max, denominator, accumulator), so O(S * kv_chunk) logits
    live at once instead of O(S^2).  Without ``causal`` every query
    attends to every (unpadded) key.

    q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) with H % KV == 0.
    """
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(dh)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    nchunks = (Skv + kv_chunk - 1) // kv_chunk
    pad = nchunks * kv_chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    qg = q.reshape(B, Sq, KV, G, dh).float()
    m = torch.full((B, Sq, KV, G), -1e30, dtype=F32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=F32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, dh), dtype=F32, device=dev)
    for c in range(nchunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kb, vb, pb = k[:, sl].float(), v[:, sl].float(), kv_positions[sl]
        logits = torch.einsum("bskgd,bckd->bskgc", qg, kb) * scale
        mask = (pb >= 0)[None, :]
        if causal:
            mask = mask & (pb[None, :] <= q_positions[:, None])
        mask = mask[None, :, None, None, :]
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new[..., None])
        l = l * alpha + torch.sum(probs, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgc,bckd->bskgd",
                                                     probs, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, dh)


def attention_block(p, x, *, positions, causal: bool = True,
                    kv_chunk: int = 1024, with_kv: bool = False):
    """Full-sequence attention (causal unless told otherwise).  Returns y
    (B, S, D), or with ``with_kv`` ``(y, k, v)``: the roped k and v a
    prefill caches."""
    q, k, v = _qkv(p, x, positions)
    pos = positions[0] if positions.dim() > 1 else positions
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk,
                            q_positions=pos, kv_positions=pos)
    y = promoted_einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return (y, k, v) if with_kv else y


def attention_decode_stacked(p, x, k_cache, v_cache, pos):
    """One-token decode against a per-layer (B, S, KV, dh) cache buffer.

    ``pos`` is a scalar (the whole batch at one position) or a (B,) vector
    of per-row positions (continuous batching: every slot at its own
    depth); a scalar takes the vector's path at equal positions, so the
    two give the same bits.  Row b's new k/v is written at ``pos[b]``, and
    the row attends to positions ``<= pos[b]``.  Returns ``(y, k_cache,
    v_cache)`` with new cache buffers, as the reference does: the write is
    a functional ``index_put`` (a copy of the buffer), where XLA's donation
    makes the reference's ``dynamic_update_slice`` an in-place write.
    """
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    rows = pos if pos.dim() == 1 else pos.expand(B)
    q, k, v = _qkv(p, x, rows[:, None])
    b = torch.arange(B, device=x.device)
    k_cache = k_cache.index_put((b, rows.long()), k[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((b, rows.long()), v[:, 0].to(v_cache.dtype))
    S, KV = k_cache.shape[1], k_cache.shape[2]
    H = q.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, -1)
    logits = torch.einsum("bskgd,bckd->bskgc", qg.float(),
                          k_cache.float()) / np.sqrt(q.shape[-1])
    mask = torch.arange(S, device=x.device)[None, :] <= rows[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgc,bckd->bskgd", probs, v_cache.float())
    out = out.reshape(B, 1, H, -1).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, k_cache, v_cache


def attention_decode(p, x, cache, pos):
    """One-token decode against a KV cache ``{"k", "v"}`` of (B, S, KV,
    dh); x: (B, 1, D).  Returns ``(y, new_cache)``."""
    y, k, v = attention_decode_stacked(p, x, cache["k"], cache["v"], pos)
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "wg": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wu": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wd": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_block(p, x):
    g = promoted_einsum("bsd,df->bsf", x, p["wg"])
    u = promoted_einsum("bsd,df->bsf", x, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return promoted_einsum("bsf,fd->bsd", h, p["wd"])


# ---------------------------------------------------------------------------
# MoE: naive (dense dispatch), lilac (detected + rewritten), grouped
# ---------------------------------------------------------------------------

def moe_param_spec(d_model: int, d_ff: int,
                   n_experts: int) -> Dict[str, ParamSpec]:
    """The MoE layer's spec tree (the reference's ``moe_spec``)."""
    return {
        "router": ParamSpec((d_model, n_experts), ("embed", "expert"),
                            dtype=F32),
        "wg": ParamSpec((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "wu": ParamSpec((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "wd": ParamSpec((n_experts, d_ff, d_model), ("expert", "mlp", "embed")),
    }


def moe_spec(d_model: int, d_ff: int, n_experts: int,
             dtype=torch.bfloat16) -> Dict[str, Tuple[Tuple[int, ...],
                                                      torch.dtype]]:
    """name -> (shape, dtype) of the MoE parameters (router in f32)."""
    return {
        "router": ((d_model, n_experts), torch.float32),
        "wg": ((n_experts, d_model, d_ff), dtype),
        "wu": ((n_experts, d_model, d_ff), dtype),
        "wd": ((n_experts, d_ff, d_model), dtype),
    }


def moe_params(spec, generator: torch.Generator, device=None
               ) -> Dict[str, torch.Tensor]:
    """Normal parameters with the reference's scale (std 1/sqrt(shape[0]),
    ``repro.models.spec.init_params``), drawn in f32 on the generator's
    device and cast."""
    device = device or generator.device
    out = {}
    for name, (shape, dtype) in spec.items():
        t = torch.randn(shape, generator=generator, device=device)
        out[name] = (t / np.sqrt(max(shape[0], 1))).to(dtype)
    return out


def moe_params_from_numpy(p: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's MoE parameters (anything numpy can read: jax
    arrays of any dtype, bf16 included) as this package's tensors."""
    out = {}
    for name in ("router", "wg", "wu", "wd"):
        a = np.asarray(p[name])
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(device)
    return out


def moe_router(p, x: torch.Tensor, topk: int, shard_ctx=None):
    """returns (gate (B,S,K) f32 normalized, idx (B,S,K) int32, aux_loss).
    With ``shard_ctx`` the rows of x are one batch shard and the
    load-balancing means are taken over the global batch (psum over the
    batch axes), as the reference's router sees the whole batch."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, topk, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # load-balancing auxiliary loss (Switch-style)
    E = p["router"].shape[-1]
    top1 = one_hot(idx[..., 0], E).float()
    if shard_ctx is None:
        me = probs.mean(dim=(0, 1))
        ce = top1.mean(dim=(0, 1))
    else:
        n = x.shape[0] * x.shape[1] * C.axis_size(shard_ctx.batch_axes)
        me = C.psum(probs.sum(dim=(0, 1)), shard_ctx.batch_axes) / n
        ce = C.psum(top1.sum(dim=(0, 1)), shard_ctx.batch_axes) / n
    aux = E * torch.sum(me * ce)
    return gate, idx.to(torch.int32), aux


def _moe_naive_2d(x, gate, idx, wg, wu, wd):
    """The canonical naive formulation — the form the LiLAC detector's
    moe_ffn matcher targets (see core/detect.py MoeMatcher)."""
    E = wg.shape[0]
    onehot = one_hot(idx, E).to(x.dtype)
    combine = torch.einsum("tke,tk->te", onehot, gate.to(x.dtype))
    g = torch.einsum("td,edf->etf", x, wg)
    u = torch.einsum("td,edf->etf", x, wu)
    h = F.silu(g) * u
    y = torch.einsum("etf,efd->etd", h, wd)
    return torch.einsum("te,etd->td", combine, y)


_LILAC_MOE: Dict[str, object] = {}


def _lilac_moe_2d(platform: str):
    """lilac.compile applied to the naive form in trace mode, as the
    reference compiles it, one per platform and cached at module level
    (detection and the rewritten graph are built once per shape
    signature)."""
    if platform not in _LILAC_MOE:
        from repro_torch import lilac
        _LILAC_MOE[platform] = lilac.compile(_moe_naive_2d, platform=platform)
    return _LILAC_MOE[platform]


@torch.compiler.allow_in_graph
def _lilac_moe(x, gate, idx, wg, wu, wd):
    """The platform's compiled MoE (:func:`_lilac_moe_2d`) on one token
    group.  Inside a ``torch.compile``'d caller it is one opaque node that
    AOT autograd's trace runs (the compiled function is made there, never
    traced by dynamo), so its ``lilac_torch::moe_ffn`` lands in the
    caller's graph."""
    return _lilac_moe_2d(x.device.type)(x, gate, idx, wg, wu, wd)


def capacity(T: int, K: int, E: int, capacity_factor: float) -> int:
    """The grouped dispatch's slots an expert (the reference's rule)."""
    return max(4, min(int(np.ceil(T * K / E * capacity_factor)), T * K))


def _moe_grouped_batched(x, gate, idx, wg, wu, wd,
                         capacity_factor: float = 2.0):
    """Capacity-bucketed grouped dispatch over groups (the leading dim):
    compute scales with top-k instead of E.  A pair past its expert's
    capacity is dropped, as in the reference.

    x: (B, T, D); gate/idx: (B, T, K).  Returns (B, T, D)."""
    B, T, D = x.shape
    K = idx.shape[-1]
    E = wg.shape[0]
    C = capacity(T, K, E, capacity_factor)
    TK = T * K
    dev = x.device
    flat_e = idx.reshape(B, TK).long()
    flat_g = gate.reshape(B, TK)
    onehot = one_hot(flat_e, E)                                  # (B, TK, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                       flat_e[..., None])[..., 0]                 # (B, TK)
    keep = pos < C
    # a dropped pair writes a row of its own past the E*C buckets
    oob = E * C + torch.arange(TK, device=dev)[None, :]
    slot = torch.where(keep, flat_e * C + pos, oob)
    xtok = x.repeat_interleave(K, dim=1)                          # (B, TK, D)
    bidx = torch.arange(B, device=dev)[:, None]
    xb = torch.zeros((B, E * C + TK, D), dtype=x.dtype, device=dev)
    xb = xb.index_put((bidx, slot), xtok)[:, :E * C].reshape(B, E, C, D)
    g = torch.einsum("becd,edf->becf", xb, wg)
    u = torch.einsum("becd,edf->becf", xb, wu)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("becf,efd->becd", h, wd).reshape(B, E * C, D)
    y = torch.cat([y, torch.zeros((B, 1, D), dtype=y.dtype, device=dev)], 1)
    back = y[bidx, torch.where(keep, slot, E * C)]                # (B, TK, D)
    back = torch.where(keep[..., None], back, 0)
    contrib = back.float() * flat_g[..., None]
    return contrib.reshape(B, T, K, D).sum(dim=2).to(x.dtype)


def _moe_grouped_shardmap(x, gate, idx, wg, wu, wd, *,
                          capacity_factor: float, shard_ctx):
    """Expert-parallel grouped MoE, the reference's per-rank function
    (Megatron-style EP): this rank's (B_loc, T, D) tokens, replicated over
    the model axis, dispatched into capacity buckets for its OWN E_loc
    experts only (no collective), its experts' FFNs run locally.
    Returns the rank's partial combine (f32, or the activations' dtype
    with ``combine_bf16``); the caller reduces it over the model axis.
    ``wg/wu/wd`` are the rank's experts of the zero-padded stack (E
    padded to a multiple of the model axis, padded experts never routed
    to), and C comes from the unpadded E, the router's width."""
    Bl, T, D = x.shape
    K = idx.shape[-1]
    E_loc = wg.shape[0]
    Cap = capacity(T, K, shard_ctx.experts, capacity_factor)
    TK = T * K
    dev = x.device
    e0 = C.axis_index(shard_ctx.model) * E_loc
    flat_e = idx.reshape(Bl, TK).long() - e0              # local expert ids
    flat_g = gate.reshape(Bl, TK)
    valid = (flat_e >= 0) & (flat_e < E_loc)
    e_cl = flat_e.clamp(0, E_loc - 1)
    onehot = one_hot(e_cl, E_loc) * valid[..., None].long()
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                       e_cl[..., None])[..., 0]
    keep = valid & (pos < Cap)
    oob = E_loc * Cap + torch.arange(TK, device=dev)[None, :]
    slot = torch.where(keep, e_cl * Cap + pos, oob)
    xtok = x.repeat_interleave(K, dim=1)                  # (B_loc, TK, D)
    bidx = torch.arange(Bl, device=dev)[:, None]
    xb = torch.zeros((Bl, E_loc * Cap + TK, D), dtype=x.dtype, device=dev)
    xb = xb.index_put((bidx, slot), xtok)[:, :E_loc * Cap].reshape(
        Bl, E_loc, Cap, D)
    g = torch.einsum("becd,edf->becf", xb, wg)
    u = torch.einsum("becd,edf->becf", xb, wu)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("becf,efd->becd", h, wd).reshape(Bl, E_loc * Cap, D)
    y = torch.cat([y, torch.zeros((Bl, 1, D), dtype=y.dtype, device=dev)], 1)
    back = y[bidx, torch.where(keep, slot, E_loc * Cap)]  # (B_loc, TK, D)
    back = torch.where(keep[..., None], back, 0)
    partial = (back.float() * flat_g[..., None]).reshape(Bl, T, K, D).sum(2)
    return partial.to(x.dtype) if shard_ctx.combine_bf16 else partial


def _moe_local_dense(fn, x, gate, idx, wg, wu, wd, *, shard_ctx):
    """The dropless function (``naive``, or ``lilac``'s compiled naive
    form) over this rank's E_loc experts: each sequence's pairs of other
    ranks' experts are given gate 0 (and a local id of 0), so the rank's
    partial sums over the model axis to the one-device result.  Returns
    the partial in f32 (the activations' dtype with ``combine_bf16``)."""
    E_loc = wg.shape[0]
    local = idx.long() - C.axis_index(shard_ctx.model) * E_loc
    valid = (local >= 0) & (local < E_loc)
    lidx = torch.where(valid, local, 0).to(idx.dtype)
    lgate = torch.where(valid, gate, 0)
    out = _per_sequence(fn, x, lgate, lidx, wg, wu, wd)
    return out if shard_ctx.combine_bf16 else out.float()


def _per_sequence(fn, x, gate, idx, wg, wu, wd):
    """The dropless ``fn`` on each sequence's tokens.  The naive form is a
    function of each token alone, so the B·S tokens run as one call: the
    same values as the reference's ``jax.vmap`` over sequences, without
    the copy of the expert weights a sequence that torch's batch rule of
    its ``etf,efd->etd`` einsum makes.  lilac's compiled form runs under
    ``torch.func.vmap``, as the reference's does: detected on one sequence,
    each harness called once for the batch (K4: 3 launches a layer, not 3
    a sequence)."""
    if fn is _moe_naive_2d:
        B, S, D = x.shape
        return fn(x.reshape(B * S, D), gate.reshape(B * S, -1),
                  idx.reshape(B * S, -1), wg, wu, wd).reshape(B, S, D)
    return torch.func.vmap(lambda xx, gg, ii: fn(xx, gg, ii, wg, wu, wd))(
        x, gate, idx)


def moe_block(p, x: torch.Tensor, *, topk: int, impl: str = "naive",
              capacity_factor: float = 2.0, shard_ctx=None):
    """x: (B, S, D).  Groups are sequences: ``naive`` and ``lilac`` run
    the dropless expert FFN of each sequence (``_per_sequence``: ``naive``
    over the B·S tokens at once, the same per-token function; ``lilac``
    through one compiled function under ``torch.func.vmap``, detected on
    one sequence, each harness called once for the batch: K4 launches 3
    times a layer); ``grouped`` runs
    the capacity-bucket dispatch over all sequences at once, dropping a
    pair past ``capacity_factor`` times an expert's mean load.  The flat
    impls take the B·S tokens as one group (decode): ``grouped_flat``
    one capacity-bucket dispatch, ``naive_flat`` one dense dispatch, the
    exact form the detector matches, so that compiling a decode step
    exposes its MoE layers.  Returns (out, aux_loss).

    With ``shard_ctx`` (a ``MeshCtx``: the reference's shard_map context)
    x is this rank's residual stream, ``p["router"]`` the whole router and
    ``p["wg"/"wu"/"wd"]`` the rank's experts of the padded stack: the
    block gathers its input over the model axis under sequence
    parallelism, routes over the global batch, runs the expert FFN of the
    rank's experts (``grouped``: the capacity dispatch
    ``_moe_grouped_shardmap``; ``naive`` / ``lilac``: the dropless
    function, lilac's K4 launches over the local experts) and reduces the
    partial sums over the model axis once (psum, or a reduce-scatter onto
    the rank's sequence chunk)."""
    if shard_ctx is not None:
        return _moe_block_mesh(p, x, topk=topk, impl=impl,
                               capacity_factor=capacity_factor,
                               shard_ctx=shard_ctx)
    gate, idx, aux = moe_router(p, x, topk)
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    B, S, D = x.shape
    if impl == "grouped":
        return _moe_grouped_batched(x, gate, idx, wg, wu, wd,
                                    capacity_factor=capacity_factor), aux
    if impl == "grouped_flat":
        out = _moe_grouped_batched(x.reshape(1, B * S, D),
                                   gate.reshape(1, B * S, -1),
                                   idx.reshape(1, B * S, -1), wg, wu, wd,
                                   capacity_factor=capacity_factor)
        return out.reshape(B, S, D), aux
    if impl in ("naive", "naive_flat"):
        fn = _moe_naive_2d
    elif impl == "lilac":
        fn = _lilac_moe
    else:
        raise ValueError(f"impl must be 'naive', 'lilac', 'grouped', "
                         f"'naive_flat' or 'grouped_flat', got {impl!r}")
    return _per_sequence(fn, x, gate, idx, wg, wu, wd), aux


# ---------------------------------------------------------------------------
# The mesh path: tensor, sequence and expert parallelism
# ---------------------------------------------------------------------------

class MeshCtx(NamedTuple):
    """What a block needs of the mesh (the reference's ``shard_ctx``):
    the batch axes, the model axis, whether the residual stream is
    sequence-parallel, the MoE combine's dtype and the unpadded expert
    count (the grouped dispatch's capacity comes from it)."""
    batch_axes: Tuple[str, ...]
    model: str
    sp: bool
    combine_bf16: bool
    experts: int = 0

    def enter(self, x):
        """A block's input over the whole sequence: the residual stream's
        sequence chunks all-gathered under sequence parallelism."""
        return C.all_gather(x, self.model, 1) if self.sp else x

    def exit(self, y, partial: bool, upcast: bool = True):
        """A block's output back to the residual stream's layout: a
        partial sum reduced over the model axis (psum, or reduce-scatter
        onto the rank's sequence chunk), in f32 unless ``upcast`` is off
        (the caller casts the sum to its dtype); a replicated result as it
        is, or the rank's chunk of it."""
        if partial:
            z = y.float() if upcast else y
            return (C.reduce_scatter(z, self.model, 1) if self.sp
                    else C.psum(z, self.model))
        return C.local_chunk(y, self.model, 1) if self.sp else y


def _kv_heads_of(n_heads: int, n_kv: int, lo_head: int, heads: int):
    """The kv heads that q heads [lo_head, lo_head + heads) attend with:
    a slice (lo, hi) when each of them serves the same number of local
    q heads (the chunked attention's GQA reshape), else the index list
    with one kv head a q head."""
    group = n_heads // n_kv
    kv = [(lo_head + j) // group for j in range(heads)]
    lo, hi = kv[0], kv[-1] + 1
    per = heads // (hi - lo)
    if heads % (hi - lo) == 0 and kv == [lo + j // per for j in range(heads)]:
        return slice(lo, hi)
    return kv


def attention_block_mesh(p, x, shard_ctx, *, n_heads: int, n_kv: int,
                         positions, causal: bool = True,
                         kv_chunk: int = 1024, with_kv: bool = False):
    """``attention_block`` with the heads over the model axis (Megatron's
    column-parallel q/k/v and row-parallel wo): ``p`` holds this rank's q
    heads (all of them where the model axis does not divide them) and its
    kv heads, or all kv heads where they are not sharded, in which case
    the rank takes the kv heads its q heads use.  The output is the
    rank's partial sum over its heads, reduced by ``shard_ctx.exit``; the
    k and v returned are the rank's kv heads."""
    h = shard_ctx.enter(x)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    heads = wq.shape[1]
    sharded = heads < n_heads
    if sharded and wk.shape[1] == n_kv:
        sel = _kv_heads_of(n_heads, n_kv,
                           C.axis_index(shard_ctx.model) * heads, heads)
        wk, wv = wk[:, sel], wv[:, sel]
    q, k, v = _qkv({"wq": wq, "wk": wk, "wv": wv}, h, positions)
    pos = positions[0] if positions.dim() > 1 else positions
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk,
                            q_positions=pos, kv_positions=pos)
    y = _row_parallel("bshk,hkd->bsd", out.to(h.dtype), p["wo"], sharded)
    y = shard_ctx.exit(y, partial=sharded).to(
        torch.promote_types(h.dtype, p["wo"].dtype))
    return (y, k, v) if with_kv else y


def _row_parallel(eq: str, a, w, partial: bool):
    """A row-parallel product: a partial sum is kept in f32 (the
    operands' exact products accumulated in f32), so that the reduction
    over the model axis rounds to the activations' dtype once, as the
    one-device product does; a whole product as ``promoted_einsum``."""
    if not partial:
        return promoted_einsum(eq, a, w)
    return torch.einsum(eq, a.float(), w.float())


def attention_decode_mesh(p, x, k_cache, v_cache, pos, shard_ctx, *,
                          n_heads: int, n_kv: int, seq_axes=()):
    """``attention_decode_stacked`` on a rank's blocks of the cache: its
    kv heads (all of them where the model axis does not divide them) and
    its chunk of the sequence where ``seq_axes`` shard it (the rank holding
    position ``pos`` writes the new k/v; the softmax is combined over those
    axes from each chunk's max, sum and weighted values, ring-style).  q
    heads are the rank's own unless the model axis shards the sequence,
    in which case every rank computes all heads on its chunk.  Returns
    ``(y, k_cache, v_cache)``, y replicated over the model axis."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    rows = pos if pos.dim() == 1 else pos.expand(B)
    wq, wo = p["wq"], p["wo"]
    sharded = wq.shape[1] < n_heads
    if sharded and shard_ctx.model in seq_axes:
        wq, wo = C.all_gather(wq, shard_ctx.model, 1), \
            C.all_gather(wo, shard_ctx.model, 0)
        sharded = False
    heads = wq.shape[1]
    q, k, v = _qkv({"wq": wq, "wk": p["wk"], "wv": p["wv"]}, x, rows[:, None])
    S_loc = k_cache.shape[1]
    s0 = C.axis_index(seq_axes) * S_loc
    local = rows.long() - s0
    mine = ((local >= 0) & (local < S_loc))[:, None, None]
    b = torch.arange(B, device=x.device)
    at = (b, local.clamp(0, S_loc - 1))
    k_cache = k_cache.index_put(at, torch.where(
        mine, k[:, 0].to(k_cache.dtype), k_cache[at]))
    v_cache = v_cache.index_put(at, torch.where(
        mine, v[:, 0].to(v_cache.dtype), v_cache[at]))
    kc, vc = k_cache, v_cache
    if sharded and kc.shape[2] == n_kv:
        sel = _kv_heads_of(n_heads, n_kv,
                           C.axis_index(shard_ctx.model) * heads, heads)
        kc, vc = kc[:, :, sel], vc[:, :, sel]
    KV = kc.shape[2]
    qg = q.reshape(B, 1, KV, heads // KV, -1)
    logits = torch.einsum("bskgd,bckd->bskgc", qg.float(),
                          kc.float()) / np.sqrt(q.shape[-1])
    keys = s0 + torch.arange(S_loc, device=x.device)
    mask = keys[None, :] <= rows[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, -1e30)
    m = C.pmax(logits.amax(-1), seq_axes)
    e = torch.exp(logits - m[..., None])
    l = C.psum(e.sum(-1), seq_axes)
    acc = C.psum(torch.einsum("bskgc,bckd->bskgd", e, vc.float()), seq_axes)
    out = (acc / l[..., None]).reshape(B, 1, heads, -1).to(x.dtype)
    y = _row_parallel("bshk,hkd->bsd", out, wo, sharded)
    y = shard_ctx.exit(y, partial=sharded).to(
        torch.promote_types(x.dtype, wo.dtype))
    return y, k_cache, v_cache


def mlp_block_mesh(p, x, shard_ctx, *, d_ff: int):
    """The SwiGLU MLP with d_ff over the model axis (column-parallel
    wg/wu, row-parallel wd)."""
    h = shard_ctx.enter(x)
    g = promoted_einsum("bsd,df->bsf", h, p["wg"])
    u = promoted_einsum("bsd,df->bsf", h, p["wu"])
    a = F.silu(g.float()).to(h.dtype) * u
    sharded = p["wg"].shape[1] < d_ff
    y = _row_parallel("bsf,fd->bsd", a, p["wd"], sharded)
    return shard_ctx.exit(y, partial=sharded).to(
        torch.promote_types(h.dtype, p["wd"].dtype))


def _moe_block_mesh(p, x, *, topk, impl, capacity_factor, shard_ctx):
    h = shard_ctx.enter(x)
    gate, idx, aux = moe_router(p, h, topk, shard_ctx)
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    B, S, D = h.shape
    flat = impl.endswith("_flat")
    if flat:        # one group of all the rank's tokens (decode)
        h, gate, idx = (h.reshape(1, B * S, D), gate.reshape(1, B * S, -1),
                        idx.reshape(1, B * S, -1))
        impl = impl[:-len("_flat")]
    if impl == "grouped":
        partial = _moe_grouped_shardmap(h, gate, idx, wg, wu, wd,
                                        capacity_factor=capacity_factor,
                                        shard_ctx=shard_ctx)
    elif impl in ("naive", "lilac"):
        fn = (_moe_naive_2d if impl == "naive"
              else _lilac_moe_2d(x.device.type))
        partial = _moe_local_dense(fn, h, gate, idx, wg, wu, wd,
                                   shard_ctx=shard_ctx)
    else:
        raise ValueError(f"impl {impl!r} has no mesh path")
    if flat:
        partial = partial.reshape(B, S, D)
    return shard_ctx.exit(partial, partial=True,
                          upcast=False).to(x.dtype), aux
