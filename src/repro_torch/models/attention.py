"""Attention: GQA + RoPE + sliding window, with a flash-style tiled online
softmax for long sequences.

Counterpart of ``repro.models.attention``: full-sequence attention
(train / prefill) and one-token decode against a position-tagged KV cache.

Layouts:
  q        : (batch, seq, heads, head_dim)
  k, v     : (batch, seq, kv_heads, head_dim)
  cache k/v: (batch, cache_len, kv_heads, head_dim)
  cache pos: (batch, cache_len) int32, -1 = empty slot

GQA is computed grouped -- q reshaped to (B, S, KV, G, D), query head h
reading KV head h // G -- so no KV repetition is materialized.  Scores and
softmax run in float32: a bfloat16 ``torch.einsum`` rounds its output to
bfloat16, so the operands are upcast first (the reference asks for a
float32 result with ``preferred_element_type``).  Everything here is plain
einsum/softmax, with forward-AD formulas for every op and its backward, so
``torch.func.jvp`` of ``torch.func.grad`` runs through it (a fused
``scaled_dot_product_attention`` has no such formula).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["apply_rope", "attention", "decode_attention",
           "sliding_window_mask"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions, head_dim, theta):
    """positions (...,) -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta=10000.0):
    """x: (B, S, H, D), positions: (B, S) or (S,); half-split (not
    interleaved) rotation in float32.  theta <= 0 disables it."""
    if theta is None or theta <= 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, D/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

def sliding_window_mask(q_pos, kv_pos, causal, window):
    """(..., Sq, 1) x (..., 1, Skv) position grids -> bool keep-mask."""
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, kv_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kv_pos <= q_pos)
    if window is not None:
        m = m & ((q_pos - kv_pos) < window)
    return m


# ---------------------------------------------------------------------------
# core attention
# ---------------------------------------------------------------------------

def _scores(q, k, scale):
    """q (B,Sq,KV,G,D) x k (B,Skv,KV,D) -> (B,KV,G,Sq,Skv) float32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _pv(p, v):
    """p (B,KV,G,Sq,Skv) x v (B,Skv,KV,D) -> (B,Sq,KV,G,D) in v's dtype."""
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def _pick_chunk(S, target):
    """Largest divisor of S that is <= target (S itself when S <= target)."""
    if S <= target:
        return S
    c = target
    while S % c:
        c -= 1
    return c


def attention(q, k, v, *, causal=True, window: Optional[int] = None,
              q_positions=None, kv_positions=None, chunk: int = 2048,
              softcap: Optional[float] = None, q_chunk: int = 1024):
    """Attention with an online softmax tiled over BOTH the query axis
    (``q_chunk``) and the KV axis (``chunk``), so the live score tensor is
    bounded by (B, H, q_chunk, chunk) whatever the sequence length; one
    untiled einsum when both sides fit.

    q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D).
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)[None, :] + (Skv - Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)[None, :]
    q_positions = q_positions.expand(B, Sq)
    kv_positions = kv_positions.expand(B, Skv)

    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, chunk)

    if qc == Sq and kc == Skv:
        qg = q.reshape(B, Sq, KV, G, D)
        s = _scores(qg, k, scale)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qp = q_positions[:, None, None, :, None]
        kp = kv_positions[:, None, None, None, :]
        keep = sliding_window_mask(qp, kp, causal, window)
        s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return _pv(p, v).reshape(B, Sq, H, D)

    # ---- 2-D tiled online softmax ----
    outs = []
    for i in range(Sq // qc):
        qg = q[:, i * qc:(i + 1) * qc].reshape(B, qc, KV, G, D)
        qp = q_positions[:, i * qc:(i + 1) * qc][:, None, None, :, None]
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, KV, G, D), dtype=torch.float32, device=dev)
        for j in range(Skv // kc):
            s = _scores(qg, k[:, j * kc:(j + 1) * kc], scale)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kp = kv_positions[:, j * kc:(j + 1) * kc][:, None, None, None, :]
            keep = sliding_window_mask(qp, kp, causal, window)
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = _pv(p, v[:, j * kc:(j + 1) * kc]).float()
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype).reshape(B, qc, H, D))
    return torch.cat(outs, dim=1)


def decode_attention(q, cache_k, cache_v, cache_pos, cur_pos, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None):
    """One-token attention against a position-tagged cache.

    q (B,1,H,D); cache_k/v (B,C,KV,D); cache_pos (B,C) (-1 empty);
    cur_pos (B,) absolute position of the query token.  Scores and softmax
    in float32; the probabilities are cast to the cache's dtype for the
    product with v, so the output is in ``cache_v.dtype``, as the
    reference's einsum returns it.
    """
    B, _, H, D = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache_k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = cache_pos[:, None, None, :]
    qp = cur_pos[:, None, None, None]
    keep = (kp >= 0) & (kp <= qp)
    if window is not None:
        keep = keep & ((qp - kp) < window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, D)
