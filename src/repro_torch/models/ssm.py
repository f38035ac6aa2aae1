"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Scoring and prefill use the chunked SSD algorithm: quadratic attention-like
work inside chunks of length Q and a linear recurrence across the chunk
summaries, O(L*Q) work and an O(1) decode state.  Decode is the exact SSM
recurrence on a (b, h, p, n) float32 state plus a (k-1)-tap causal conv
cache.  The reference's ``lax.scan`` over chunks is a Python loop here,
carrying the state explicitly.

Layout: b batch, l seq, h heads, p headdim, g B/C groups, n state dim.
Mixed-dtype products promote as ``jnp.einsum`` does (bfloat16 with float32
gives float32), so each product is computed in the reference's type.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, dense_init, dtype_of, normal, rmsnorm
from repro_torch.sharding import tp


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype (``jnp.einsum``'s rule)."""
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_init(gen: torch.Generator, cfg) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree, on the generator's device."""
    d, d_inner, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    dtype = dtype_of(cfg.dtype)
    dev = gen.device
    # in_proj -> [z (d_inner), x (d_inner), B (g*n), C (g*n), dt (h)]
    return {
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * g * n + h, dtype),
        "conv_w": normal(gen, (cfg.conv_kernel, conv_dim), 0.1, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, dtype=torch.float32, device=dev))),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=dev)},
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


class Mamba2(nn.Module):
    """The parameters of :func:`mamba2_init` as an ``nn.Module``; ``forward``
    is :func:`mamba2_apply`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, d_inner, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
        conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        dtype = dtype_of(cfg.dtype)
        empty = lambda *shape, dt=dtype: nn.Parameter(torch.empty(shape, dtype=dt, device=device))  # noqa: E731
        self.in_proj = empty(d, 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + h)
        self.conv_w = empty(cfg.conv_kernel, conv_dim)
        self.conv_b = empty(conv_dim)
        self.A_log = empty(h, dt=torch.float32)
        self.D = empty(h, dt=torch.float32)
        self.dt_bias = empty(h, dt=torch.float32)
        self.norm = RMSNorm(d_inner, dtype, device)
        self.out_proj = empty(d_inner, d)

    @torch.no_grad()
    def init_(self, gen: torch.Generator, cfg) -> None:
        p = mamba2_init(gen, cfg)
        for name, t in p.items():
            if name == "norm":
                self.norm.scale.copy_(t["scale"])
            else:
                getattr(self, name).copy_(t)

    def params(self) -> Dict:
        p = dict(self.named_parameters(recurse=False))
        p["norm"] = {"scale": self.norm.scale}
        return p

    def forward(self, hidden: torch.Tensor, cfg, cache: Optional[dict] = None):
        return mamba2_apply(self.params(), hidden, cfg, cache=cache)


def _split_proj(proj: torch.Tensor, cfg):
    d_inner, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner : 2 * d_inner + 2 * g * n]
    dt = proj[..., 2 * d_inner + 2 * g * n :]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq; xBC (b, l, c), w (k, c)."""
    k = w.shape[0]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + xBC.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum_decay(dtA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dtA: (..., q, h) chunk-local decays.  Returns (cumsum (..., q, h),
    L (..., h, q, q)) with L[i,j] = exp(sum_{j<m<=i} dtA[m]) for i>=j else 0."""
    cum = torch.cumsum(dtA, dim=-2)  # (..., q, h)
    ci = cum.transpose(-1, -2)[..., :, :, None]  # (..., h, q, 1)
    cj = cum.transpose(-1, -2)[..., :, None, :]  # (..., h, 1, q)
    q = dtA.shape[-2]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dtA.device))
    # Double where: the masked-out (i < j) exponents are positive sums of
    # |dtA| and overflow exp to inf for long chunks or large A, which makes
    # the where's backward inf * 0 = NaN.  Zeroing diff before exp keeps the
    # untaken branch finite; in-mask values are untouched.
    diff = torch.where(mask, ci - cj, 0.0)
    L = torch.where(mask, torch.exp(diff), 0.0)
    return cum, L


def ssd_chunked(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h) positive
    A: torch.Tensor,  # (h,) positive decay rates (the state decays by exp(-dt*A))
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (b, l, h, p), final state (b, h, p, n))."""
    bsz, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = x.shape[1]
    nc = L // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    Bh = B.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (b,nc,q,h,n)
    Ch = C.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dtA = -dtc * A[None, None, None, :]  # (b,nc,q,h) negative
    cum, Lmat = _segsum_decay(dtA)  # cum (b,nc,q,h); Lmat (b,nc,h,q,q)
    xdt = xc * dtc[..., None]  # (b,nc,q,h,p)

    # intra-chunk (quadratic, attention-like)
    scores = _einsum("bcihn,bcjhn->bchij", Ch, Bh)  # (b,nc,h,q,q)
    y_intra = _einsum("bchij,bchij,bcjhp->bcihp", scores, Lmat, xdt)

    # chunk summary states: decay from each position to the chunk's end
    decay_end = torch.exp(cum[..., -1:, :] - cum)  # (b,nc,q,h)
    S_chunk = _einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_end, xdt)  # (b,nc,h,p,n)

    # inter-chunk recurrence over the chunk states, in float32
    chunk_decay = torch.exp(torch.sum(dtA, dim=2))  # (b,nc,h)
    S = (initial_state if initial_state is not None
         else torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)).to(torch.float32)
    S_chunk = S_chunk.to(torch.float32)
    S_prevs = []  # the state entering each chunk
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (b,nc,h,p,n)

    # inter-chunk contribution: C_i * decay from the chunk's start * S_prev
    decay_in = torch.exp(cum)  # (b,nc,q,h)
    y_inter = _einsum("bcqhn,bcqh,bchpn->bcqhp", Ch, decay_in, S_prevs.to(x.dtype))

    y = (y_intra + y_inter).reshape(bsz, L, h, p)[:, :l]
    return y, S.to(x.dtype)


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """Sequential oracle: the exact per-step recurrence (tests, tiny shapes)."""
    bsz, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    S = (initial_state.to(torch.float32) if initial_state is not None
         else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(l):
        dA = torch.exp(-dt[:, t] * A[None, :])  # (b,h)
        S = S * dA[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", x[:, t].to(torch.float32), Bh[:, t].to(torch.float32), dt[:, t]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t].to(torch.float32)))
    return torch.stack(ys, dim=1).to(x.dtype), S.to(x.dtype)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence.  state (b,h,p,n); x_t (b,h,p); dt_t (b,h);
    B_t/C_t (b,g,n).  Returns (y (b,h,p), new state)."""
    h = x_t.shape[1]
    rep = h // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)
    Ch = C_t.repeat_interleave(rep, dim=1)
    dA = torch.exp(-dt_t * A[None, :])
    state = state * dA[:, :, None, None] + _einsum("bhp,bhn,bh->bhpn", x_t, Bh, dt_t)
    y = _einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


# ---------------------------------------------------------------------------
# the full Mamba2 block


def mamba2_apply(
    params: Mapping,
    hidden: torch.Tensor,  # (b, l, d_model)
    cfg,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 block.  ``cache={"conv": (b, k-1, conv_dim), "state": (b, h,
    p, n)}`` enables single- or few-token decode and returns the new cache
    (new tensors; the caller stores them); ``cache=None`` is scoring.

    Over a "model" mesh axis the block is computed whole on every model rank
    (the rules split ``in_proj`` on its fused ``[z | x | B | C | dt]``
    columns, which do not fall on SSD heads): replicated compute over
    gathered weights.  A cache the mesh splits (``conv`` on ``conv_dim``,
    ``state`` on heads) is gathered here and the new one cut back to this
    rank's block."""
    bsz, l, _ = hidden.shape
    h, p, g, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * g * n
    if cache is not None and (cache["conv"].shape[-1], cache["state"].shape[-3]) != (conv_dim, h):
        local = {k: t.shape for k, t in cache.items()}
        whole = {"conv": tp.whole(cache["conv"], -1, conv_dim), "state": tp.whole(cache["state"], -3, h)}
        out, new = mamba2_apply(params, hidden, cfg, cache=whole)
        return out, {"conv": tp.own_block(new["conv"], -1, local["conv"][-1]),
                     "state": tp.own_block(new["state"], -3, local["state"][-3])}
    proj = hidden @ params["in_proj"]
    z, xBC_raw, dt_raw = _split_proj(proj, cfg)
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (b,l,h)
    A = torch.exp(params["A_log"])  # (h,) positive

    new_cache = None
    if cache is None:
        xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
    else:
        k = cfg.conv_kernel
        window = torch.cat([cache["conv"].to(xBC_raw.dtype), xBC_raw], dim=1)
        xBC = _causal_conv(window, params["conv_w"], params["conv_b"])[:, k - 1 :]
        new_conv = window[:, -(k - 1) :] if k > 1 else window[:, :0]

    x = xBC[..., : cfg.d_inner].reshape(bsz, l, h, p)
    B = xBC[..., cfg.d_inner : cfg.d_inner + g * n].reshape(bsz, l, g, n)
    C = xBC[..., cfg.d_inner + g * n :].reshape(bsz, l, g, n)

    if cache is None:
        y, _final = ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk)
    elif l == 1:
        y1, state = ssd_decode_step(
            cache["state"].to(torch.float32),
            x[:, 0].to(torch.float32),
            dt[:, 0],
            A,
            B[:, 0].to(torch.float32),
            C[:, 0].to(torch.float32),
        )
        y = y1[:, None].to(hidden.dtype)
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "state": state.to(cache["state"].dtype)}
    else:
        y, state = ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk, initial_state=cache["state"].to(x.dtype))
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "state": state.to(cache["state"].dtype)}

    y = y + x * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, l, cfg.d_inner).to(hidden.dtype)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"]["scale"], y, cfg.norm_eps)
    out = (y @ params["out_proj"]).to(hidden.dtype)
    return out, new_cache


def init_mamba_cache(batch: int, cfg, dtype, device=None) -> dict:
    """``conv`` in ``dtype``; ``state`` in float32 whatever ``dtype`` is."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }
