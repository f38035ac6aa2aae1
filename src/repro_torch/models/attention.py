"""GQA attention with RoPE, a KV cache, cross-attention over precomputed
encoder K/V, and three interchangeable impls.

  naive      full materialised scores
  xla_flash  blockwise online softmax in plain torch, with the reference's
             block sizes and causal-scheduling trip counts (the reference
             writes it in XLA, not Pallas, so its port is not a kernel)
  pallas     the flash-attention kernel (``kernels/flash_attention``): CUDA
             on the card, its plain twin on the CPU; the kernel is causal
             only, so a non-causal call (an encoder's, a cross-attention)
             runs ``naive``, as in the reference

All impls share one set of weights and agree to ~1e-5 in float32.  A
whole-prompt prefill (``from_zero``) under ``pallas`` runs the flash kernel
over the prompt's own K/V (at position 0 the cache slots past the prompt
are in every query's causal future); the reference's prefill runs its
blockwise XLA attention there, equal within rounding.

The reference's ``mesh_axes`` place layout hints (``with_sharding_constraint``
on the heads and the batch) that carry no arithmetic; the port accepts them
as such.  The split compute comes from the tensor-parallel context
(:mod:`repro_torch.sharding.tp`) the mesh layer sets: when the heads split
(``n_heads`` and ``n_kv_heads`` both divisible by the "model" size), the
parameters are this rank's heads (``wqkv``/``bqkv`` its q, k and v heads,
``wo`` its q heads), the input enters through ``copy_to_model``, the cache
holds its kv heads, and ``wo``'s partial product is summed over "model".
Otherwise every model rank computes the attention whole from the whole
weights (the reference's "replicate the head axis" branch, logged once a
configuration), gathering a cache whose ``head_dim`` the mesh splits.
A KV cache is updated in place (the reference returns a new one); the
returned cache dict holds the same tensors with ``pos`` advanced.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, normal
from repro_torch.sharding import tp

_NEG_INF = -1e30


def attention_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   qkv_bias: bool, dtype) -> Dict[str, torch.Tensor]:
    """Head-major fused projections, on the generator's device:

      wqkv (d, H_total, hd)  H_total = hq + 2*hkv, layout [q | k | v]
      wo   (hq, hd, d)
      bqkv (H_total, hd)     zeros, when ``qkv_bias``
    """
    n_total = n_heads + 2 * n_kv_heads
    p = {
        "wqkv": normal(gen, (d_model, n_total, head_dim), 1.0 / math.sqrt(d_model), dtype),
        "wo": normal(gen, (n_heads, head_dim, d_model), 1.0 / math.sqrt(n_heads * head_dim), dtype),
    }
    if qkv_bias:
        p["bqkv"] = torch.zeros((n_total, head_dim), dtype=dtype, device=gen.device)
    return p


class Attention(nn.Module):
    """The parameters of :func:`attention_init` as an ``nn.Module``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, qkv_bias: bool,
                 dtype, device=None):
        super().__init__()
        n_total = n_heads + 2 * n_kv_heads
        self.wqkv = nn.Parameter(torch.empty((d_model, n_total, head_dim), dtype=dtype, device=device))
        self.wo = nn.Parameter(torch.empty((n_heads, head_dim, d_model), dtype=dtype, device=device))
        if qkv_bias:
            self.bqkv = nn.Parameter(torch.empty((n_total, head_dim), dtype=dtype, device=device))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        h_total, hd = self.wqkv.shape[1], self.wqkv.shape[2]
        n_heads = self.wo.shape[0]
        p = attention_init(gen, self.wqkv.shape[0], n_heads, (h_total - n_heads) // 2, hd,
                           hasattr(self, "bqkv"), self.wqkv.dtype)
        for name, t in p.items():
            getattr(self, name).copy_(t)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


def qkv_slices(params: Mapping[str, torch.Tensor], n_heads: int, n_kv_heads: int, head_dim: int):
    """(wq, wk, wv) head-axis slices of the fused projection (cross-attention
    use), each reshaped back to 2-D (d, h*hd)."""
    w = params["wqkv"]
    d = w.shape[0]
    wq = w[:, :n_heads].reshape(d, n_heads * head_dim)
    wk = w[:, n_heads : n_heads + n_kv_heads].reshape(d, n_kv_heads * head_dim)
    wv = w[:, n_heads + n_kv_heads :].reshape(d, n_kv_heads * head_dim)
    return wq, wk, wv


def _project_qkv(params: Mapping[str, torch.Tensor], x: torch.Tensor, n_heads: int, n_kv_heads: int):
    qkv = torch.einsum("bsd,dhf->bhsf", x, params["wqkv"])  # (b, H_total, s, hd)
    if "bqkv" in params:
        qkv = qkv + params["bqkv"][None, :, None, :]
    q = qkv[:, :n_heads]
    k = qkv[:, n_heads : n_heads + n_kv_heads]
    v = qkv[:, n_heads + n_kv_heads :]
    return q, k, v


def _repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    if group == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, group, s, d).reshape(b, h * group, s, d)


# ---------------------------------------------------------------------------
# core attention impls (q: (b,hq,sq,d), k/v: (b,hkv,sk,d))


def _attend_naive(q, k, v, *, causal: bool, kv_offset: int, scale: float):
    group = q.shape[1] // k.shape[1]
    kr, vr = _repeat_kv(k, group), _repeat_kv(v, group)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr.to(torch.float32)) * scale
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[:, None] + kv_offset
        col = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(col <= row, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.to(torch.float32)).to(q.dtype)


def _attend_xla_flash(
    q, k, v, *, causal: bool, kv_offset: int, scale: float,
    block_q: int = 512, block_k: int = 1024, causal_scheduling: bool = True,
    dynamic: bool = False,
):
    """Blockwise online-softmax attention in plain torch.

    Memory O(block_q * block_k) per (batch, head).  With causal scheduling
    q block i visits kv blocks 0 .. last_row // block_k only, with the
    reference's trip counts (``dynamic`` selects its inference variant's
    clamp, which may run no block).  The ragged last blocks are sliced
    short instead of padded: padded kv columns would be masked to -1e30 and
    padded query rows dropped, so the result is the same.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    outs = []
    for i_q in range(nq):
        qblk = q[:, :, i_q * block_q : (i_q + 1) * block_q].to(torch.float32)
        n_rows = qblk.shape[2]
        rows = i_q * block_q + torch.arange(n_rows, device=q.device) + kv_offset
        m = torch.full((b, hq, n_rows), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, n_rows), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hq, n_rows, d), dtype=torch.float32, device=q.device)
        n_run = nk
        if causal and causal_scheduling:
            last_row = i_q * block_q + (block_q - 1) + kv_offset
            n_run = min(max(last_row // block_k + 1, 0 if dynamic else 1), nk)
        for i_k in range(n_run):
            sl = slice(i_k * block_k, (i_k + 1) * block_k)
            kblk = _repeat_kv(k[:, :, sl], group).to(torch.float32)
            vblk = _repeat_kv(v[:, :, sl], group).to(torch.float32)
            s = torch.einsum("bhqd,bhkd->bhqk", qblk, kblk) * scale
            if causal:
                cols = i_k * block_k + torch.arange(kblk.shape[2], device=q.device)
                s = torch.where(cols[None, :] <= rows[:, None], s, _NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def _attend(q, k, v, *, impl: str, causal: bool, kv_offset: int, scale: float,
            causal_scheduling: bool = True):
    if impl == "naive":
        return _attend_naive(q, k, v, causal=causal, kv_offset=kv_offset, scale=scale)
    if impl == "xla_flash":
        return _attend_xla_flash(
            q, k, v, causal=causal, kv_offset=kv_offset, scale=scale,
            causal_scheduling=causal_scheduling,
        )
    if impl == "pallas":
        from repro_torch.kernels.flash_attention.ops import flash_attention

        if not causal:
            return _attend_naive(q, k, v, causal=False, kv_offset=kv_offset, scale=scale)
        # the kernel reads contiguous (b, h, s, d); v is a strided slice of the projection
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# public block API


def attention_apply(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,  # (b, s, d_model)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    impl: str = "xla_flash",
    causal: bool = True,
    pos_type: str = "rope",
    rope_theta: float = 1e6,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal_scheduling: bool = True,
    from_zero: bool = False,
    mesh_axes: tuple = (),
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention call.  Modes:

      * scoring/training: cache=None -> full self-attention over x
      * prefill/decode:   cache={"k","v","pos"} -> write x's kv at pos (in
        place), attend over the cache
      * cross-attention:  cross_kv=(k, v) precomputed from the encoder ->
        q only, attending over all of (k, v) without a causal mask

    Returns (output (b,s,d_model), the cache with pos advanced, or None).
    ``mesh_axes`` are layout hints (module docstring); the tensor-parallel
    context in force decides the split.
    """
    del mesh_axes
    ctx = tp.active()
    split = ctx is not None and ctx.heads
    if split:
        n_heads, n_kv_heads = n_heads // ctx.size, n_kv_heads // ctx.size
        x = tp.copy_to_model(x)
    elif ctx is not None:
        tp.note_replicated("attention", n_heads, n_kv_heads)
    out, new_cache = _attention(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, impl=impl,
                                causal=causal, pos_type=pos_type, rope_theta=rope_theta, positions=positions,
                                cache=cache, cross_kv=cross_kv, causal_scheduling=causal_scheduling,
                                from_zero=from_zero)
    return (tp.reduce_from_model(out) if split else out), new_cache


def _attention(params, x, *, n_heads, n_kv_heads, head_dim, impl, causal, pos_type, rope_theta, positions,
               cache, cross_kv, causal_scheduling, from_zero):
    """:func:`attention_apply` on this rank's heads (its output projection
    a partial sum when they are split)."""
    b, s = x.shape[0], x.shape[1]
    scale = 1.0 / float(head_dim) ** 0.5
    new_cache = None
    if cross_kv is not None:
        wq, _, _ = qkv_slices(params, n_heads, n_kv_heads, head_dim)
        q = (x @ wq).reshape(b, s, n_heads, head_dim).transpose(1, 2)
        if "bqkv" in params:
            q = q + params["bqkv"][None, :n_heads, None, :]
        k, v = (tp.whole(t, -1, head_dim) for t in cross_kv)
        out = _attend(q, k, v, impl=impl, causal=False, kv_offset=0, scale=scale)
        return torch.einsum("bhsf,hfd->bsd", out, params["wo"]), None
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads)
    if cache is not None:
        pos = int(cache["pos"])  # number of valid cache entries
        if positions is None:
            positions = pos + torch.arange(s, device=x.device)
        if pos_type == "rope":
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        ck, cv = cache["k"], cache["v"]
        local = ck.shape[-1]  # head_dim, or this rank's block of it
        ck[:, :, pos : pos + s] = tp.own_block(k, -1, local).to(ck.dtype)
        cv[:, :, pos : pos + s] = tp.own_block(v, -1, local).to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        if local != head_dim:  # the mesh splits head_dim: attend over the whole cache
            ck, cv = tp.gather_model(ck, -1), tp.gather_model(cv, -1)
        S = ck.shape[2]
        # Causality against absolute positions also hides cache slots
        # beyond pos+s (they sit in every query's causal future).
        if s > 8 and impl != "naive":
            if from_zero and impl == "pallas":
                # whole-prompt prefill through the flash kernel: at pos 0 the
                # prompt's own K/V are the cache's only visible entries
                out = _attend(q, k, v, impl="pallas", causal=True, kv_offset=0, scale=scale)
            elif from_zero:
                # whole-prompt prefill: pos == 0, static trip counts
                bq = 2048 if s >= 8192 else 512
                out = _attend_xla_flash(
                    q, ck, cv, causal=True, kv_offset=0, scale=scale,
                    causal_scheduling=causal_scheduling, dynamic=False, block_q=bq, block_k=bq,
                )
            else:
                # chunked prefill at a cache position
                out = _attend_xla_flash(
                    q, ck, cv, causal=True, kv_offset=pos, scale=scale,
                    causal_scheduling=causal_scheduling, dynamic=True,
                )
        else:
            group = n_heads // n_kv_heads
            kr, vr = _repeat_kv(ck, group), _repeat_kv(cv, group)
            sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr.to(torch.float32)) * scale
            row = positions if positions.ndim == 2 else positions[None, :]  # (b|1, s)
            mask = torch.arange(S, device=x.device)[None, None, None, :] <= row[:, None, :, None]
            sc = torch.where(mask, sc, _NEG_INF)
            p = torch.softmax(sc, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", p, vr.to(torch.float32)).to(x.dtype)
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if pos_type == "rope":
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        out = _attend(
            q, k, v, impl=impl, causal=causal, kv_offset=0, scale=scale,
            causal_scheduling=causal_scheduling,
        )
    # head-major output projection: contraction over (h, hd)
    return torch.einsum("bhsf,hfd->bsd", out, params["wo"]), new_cache


def init_kv_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int, dtype, device=None) -> dict:
    return {
        "k": torch.zeros((batch, n_kv_heads, max_len, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, n_kv_heads, max_len, head_dim), dtype=dtype, device=device),
        "pos": 0,
    }
