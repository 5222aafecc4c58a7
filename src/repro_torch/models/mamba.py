"""Mamba selective SSM block (Jamba's recurrent layer, arXiv:2403.19887).

Counterpart of ``repro.models.mamba``.  Structure: in_proj -> (x, z); a
causal depthwise conv (k=4) + SiLU on x; data-dependent (dt, B, C),
each RMSNormed; the diagonal selective scan
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t + D x_t
and out = (y * SiLU(z)) @ out_proj.

State: (B, d_inner, N) f32 + the conv tail (B, 3, d_inner), so a decode
step costs the same at any depth of the sequence.  The casts are the
reference's: the conv runs in ``x.dtype``, SiLU in f32 cast back, ``dbc``
in ``x.dtype`` then f32; the norms, softplus, the state and ``y`` are f32,
and ``y * SiLU(z)`` is cast to ``x.dtype`` before ``out_proj``.  The
recurrence runs through ``layers.chunked_scan`` (a loop over time, each
chunk under ``torch.utils.checkpoint`` when grad is on), as the
reference scans it with ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.models.layers import (_row_parallel, chunked_scan,
                                      out_projection, promoted_einsum)
from repro_torch.models.spec import ParamSpec

F32 = torch.float32
CONV_K = 4


def mamba_spec(d: int, expand: int = 2, d_state: int = 16,
               dt_rank: int = 0) -> Dict[str, ParamSpec]:
    di = expand * d
    dt_rank = dt_rank or max(16, d // 16)
    # the reference's init: a down-scaled residual writer (out_proj), small
    # data-dependent projections (wx_dbc), the dt/B/C RMSNorms of Jamba
    # §3, dt = softplus(dt_bias) = 0.01 and A = -[1..N]
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((CONV_K, di), (None, "mlp"), dtype=F32),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros", dtype=F32),
        "wx_dbc": ParamSpec((di, dt_rank + 2 * d_state), ("mlp", None),
                            scale=0.1),
        "dt_norm": ParamSpec((dt_rank,), (None,), init="ones", dtype=F32),
        "b_norm": ParamSpec((d_state,), (None,), init="ones", dtype=F32),
        "c_norm": ParamSpec((d_state,), (None,), init="ones", dtype=F32),
        "dt_proj": ParamSpec((dt_rank, di), (None, "mlp"), dtype=F32),
        "dt_bias": ParamSpec((di,), ("mlp",), init="dt_bias", scale=0.01,
                             dtype=F32),
        "a_log": ParamSpec((di, d_state), ("mlp", None), init="arange_log",
                           dtype=F32),
        "d_skip": ParamSpec((di,), ("mlp",), init="ones", dtype=F32),
        "out_proj": ParamSpec((di, d), ("mlp", "embed"), scale=0.125),
    }


def _rms(x, eps: float = 1e-6):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps)


def _causal_conv(x, w, b, tail):
    """x: (B, S, di); w: (K, di) depthwise; tail: (B, K-1, di), the last
    K-1 inputs of the previous call (zeros at the start).  Returns (out,
    new_tail), both in ``x.dtype``."""
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = 0
    for i in range(CONV_K):
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(CONV_K - 1):, :]


def _reduced(shard_ctx, eq: str, a, w):
    """A row-parallel product over the model axis: the f32 partial sums
    reduced, then rounded once to the operands' promoted dtype, as the
    one-device product rounds."""
    y = C.psum(_row_parallel(eq, a, w, True), shard_ctx.model)
    return y.to(torch.promote_types(a.dtype, w.dtype))


def mamba_block(p, x, state: Tuple, d_state: int = 16, shard_ctx=None):
    """x: (B, S, D); state = (ssm (B, di, N) f32, conv tail (B, K-1, di)).
    Returns (out (B, S, D), (ssm, conv tail in ``x.dtype``)).  On the mesh
    ``p`` and ``state`` hold the rank's channels (di/M of them)."""
    ssm, conv_tail = state
    if shard_ctx is not None:
        x = shard_ctx.enter(x)
    di = p["in_proj"].shape[1] // 2
    dt_rank = p["dt_proj"].shape[0]
    xz = promoted_einsum("bsd,de->bse", x, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_tail = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_tail)
    xi = F.silu(xi.float()).to(x.dtype)
    dbc = (promoted_einsum("bse,ef->bsf", xi, p["wx_dbc"]) if shard_ctx is None
           else _reduced(shard_ctx, "bse,ef->bsf", xi, p["wx_dbc"])).float()
    dt_in = _rms(dbc[..., :dt_rank]) * p["dt_norm"]
    dt = F.softplus(torch.einsum("bsr,re->bse", dt_in, p["dt_proj"])
                    + p["dt_bias"])                             # (B,S,di)
    Bm = _rms(dbc[..., dt_rank:dt_rank + d_state]) * p["b_norm"]   # (B,S,N)
    Cm = _rms(dbc[..., dt_rank + d_state:]) * p["c_norm"]          # (B,S,N)
    A = -torch.exp(p["a_log"])                                  # (di,N)
    xf = xi.float()

    def step(h, inp):
        dt_t, b_t, c_t, x_t = inp          # (B,di),(B,N),(B,N),(B,di)
        da = torch.exp(dt_t[..., None] * A)                     # (B,di,N)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        return h, torch.einsum("ben,bn->be", h, c_t)

    xs = tuple(a.transpose(0, 1) for a in (dt, Bm, Cm, xf))
    ssm, ys = chunked_scan(step, ssm, xs)
    y = ys.transpose(0, 1) + xf * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return (out_projection("bse,ed->bsd", y, p["out_proj"], shard_ctx),
            (ssm, new_tail))
