"""RWKV6 (Finch) blocks: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro.models.rwkv``: arXiv:2404.05892's computation
(token-shift lerp, per-channel data-dependent decay w_t = exp(-exp(.)),
a per-head matrix-valued state S += k^T v with diagonal decay, the bonus
term u) with the reference's one simplification: the low-rank mix and
decay projections are single matrices.  The state of a head is (dh, dh)
in f32, carried across calls, so a decode step costs the same at any
depth of the sequence.

``timemix`` scans the recurrence over time with ``layers.chunked_scan``
(a loop over time, each chunk under ``torch.utils.checkpoint`` when grad
is on), as the reference scans it with ``lax.scan``.

On the mesh (``shard_ctx``, a ``layers.MeshCtx``) both mixers are
tensor-parallel over the model axis, as the reference's compute rules
split them: the time mix by heads (``wr``/``wk``/``wv``/``ww``/``wg``
column-parallel, ``u``/``w_bias``/``ln_scale`` and the state the rank's
heads, ``wo`` row-parallel), the channel mix by ``d_ff`` (``wk``
column-parallel, ``wv`` row-parallel, ``wr`` whole); a row-parallel
product's f32 partial sum is reduced by ``shard_ctx.exit`` and rounded
once.  The token shift reads the whole ``x``, which the recurrent
families keep replicated over the model axis.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (chunked_scan, out_projection,
                                      promoted_einsum)
from repro_torch.models.spec import ParamSpec

F32 = torch.float32


def timemix_spec(d: int, n_heads: int) -> Dict[str, ParamSpec]:
    return {
        "mix_r": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "mix_k": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "mix_v": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "mix_w": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "mix_g": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "ww": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "w_bias": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "u": ParamSpec((d,), (None,), init="zeros", dtype=F32),  # bonus
        "ln_scale": ParamSpec((d,), (None,), init="ones", dtype=F32),
    }


def channelmix_spec(d: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "mix_k": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "mix_r": ParamSpec((d,), (None,), init="zeros", dtype=F32),
        "wk": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wv": ParamSpec((d_ff, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "embed")),
    }


def _token_shift(x, x_prev_last=None):
    """x shifted right by one along the sequence; ``x_prev_last`` (B, D)
    is the carry of a decode step."""
    if x_prev_last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return x_prev_last[:, None, :]


def _lerp(x, prev, mix):
    return x + (prev - x) * mix.to(x.dtype)


def _proj(x, w, eq: str = "bsd,de->bse"):
    """A product at the promoted dtype of its operands, as JAX promotes
    (a decode step's f32 carry against bf16 weights computes in f32)."""
    return promoted_einsum(eq, x, w)


def timemix(p, x, state, n_heads: int, x_prev=None, shard_ctx=None):
    """x: (B, S, D); state: (B, H, dh, dh) f32.  Returns (out, new_state,
    last_x), last_x the carry of the next call's token shift.  On the mesh
    ``p`` holds the rank's heads (the projections' columns, ``wo``'s rows,
    ``u``/``w_bias``/``ln_scale``) and ``state`` is (B, H_loc, dh, dh)."""
    B, S, D = x.shape
    dh = D // n_heads
    if shard_ctx is not None:
        x = shard_ctx.enter(x)
        S = x.shape[1]
    n_heads = p["wr"].shape[1] // dh          # the rank's heads
    prev = _token_shift(x, x_prev)
    r = _proj(_lerp(x, prev, p["mix_r"]), p["wr"])
    k = _proj(_lerp(x, prev, p["mix_k"]), p["wk"])
    v = _proj(_lerp(x, prev, p["mix_v"]), p["wv"])
    g = _proj(_lerp(x, prev, p["mix_g"]), p["wg"])
    wdec = _proj(_lerp(x, prev, p["mix_w"]), p["ww"])
    w = torch.exp(-torch.exp(wdec.float() + p["w_bias"]))   # in (0, 1)

    rh = r.reshape(B, S, n_heads, dh).float()
    kh = k.reshape(B, S, n_heads, dh).float()
    vh = v.reshape(B, S, n_heads, dh).float()
    wh = w.reshape(B, S, n_heads, dh)
    uh = p["u"].reshape(n_heads, dh)

    def step(s, inp):
        rt, kt, vt, wt = inp                       # (B,H,dh) each
        kv = kt[..., :, None] * vt[..., None, :]   # (B,H,dh,dh)
        out = torch.einsum("bhi,bhij->bhj", rt, s + uh[..., None] * kv)
        return wt[..., None] * s + kv, out

    xs = tuple(a.transpose(0, 1) for a in (rh, kh, vh, wh))
    state, outs = chunked_scan(step, state, xs)
    oh = outs.transpose(0, 1)                      # (B,S,H,dh)
    # per-head group norm
    mu = torch.mean(oh, dim=-1, keepdim=True)
    var = torch.var(oh, dim=-1, keepdim=True, unbiased=False)
    oh = (oh - mu) * torch.rsqrt(var + 64e-5)
    out = (oh.reshape(B, S, n_heads * dh) * p["ln_scale"]).to(x.dtype)
    out = out * F.silu(g.float()).to(x.dtype)
    return (out_projection("bsd,de->bse", out, p["wo"], shard_ctx), state,
            x[:, -1, :])


def channelmix(p, x, x_prev=None, shard_ctx=None):
    """Returns (out, last_x).  On the mesh ``p["wk"]`` / ``p["wv"]`` are
    the rank's columns / rows of d_ff and ``wr`` is whole."""
    if shard_ctx is not None:
        x = shard_ctx.enter(x)
    prev = _token_shift(x, x_prev)
    xk = _lerp(x, prev, p["mix_k"])
    xr = _lerp(x, prev, p["mix_r"])
    k = torch.square(torch.relu(_proj(xk, p["wk"]).float())).to(x.dtype)
    kv = out_projection("bsf,fd->bsd", k, p["wv"], shard_ctx)
    r = torch.sigmoid(_proj(xr, p["wr"]).float())
    return r.to(x.dtype) * kv, x[:, -1, :]
