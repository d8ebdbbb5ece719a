"""Mamba-2 SSD (state-space duality) block: chunked training scan and O(1)
single-token decode.

Counterpart of ``repro.models.ssm``.  Selective state space with a scalar
decay per head (the SSD restriction):

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t (x) x_t      h: (H, P, N)
    y_t = C_t . h_t + D_h * x_t

Training and prefill use the SSD chunked algorithm (Dao & Gu 2024): the
sequence is cut into chunks of Q tokens; within a chunk the recurrence is
an attention-like quadratic form (einsums), across chunks a Python loop
over the nc chunks carries the (H, P, N) state (the reference's
``lax.scan``).  The intra-chunk decay is masked to -inf BEFORE ``exp``:
exponentiating first would give inf * 0 = NaN in a second derivative.

Shapes: x (B, S, d_model); internally (B, S, H, P) with H = ssm_heads,
P = ssm_head_dim, N = ssm_state; one group (B/C shared across heads).
The functions are pure, as the reference's: they return new states, and
the stacks (``models.transformer``) write them into the decode state.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import rms_norm, silu, softplus

__all__ = ["ssm_forward", "ssm_decode_step", "init_ssm_state",
           "ssd_chunked", "ssd_scan_ref"]

CHUNK = 128  # SSD chunk length (Q)

f32 = torch.float32


def _proj(x, w):
    return torch.einsum("bsd,df->bsf", x, w)


def _conv1d_causal(x, kernel, state=None):
    """Depthwise causal conv. x (B, S, F), kernel (W, F).  Returns (y,
    new_state), the state the last W-1 inputs for streaming decode."""
    W = kernel.shape[0]
    S = x.shape[1]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (W - 1,) + x.shape[2:])
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, F)
    # the W shifted slices, not unfold: vmap has no batching rule for
    # unfold's backward (the curvature engine's vmap of jvp of grad)
    kernel = kernel.to(xp.dtype)
    y = xp[:, :S] * kernel[0]
    for w in range(1, W):
        y = y + xp[:, w:w + S] * kernel[w]
    return y, xp[:, S:]


def _segsum(dA):
    """dA (..., Q) -> L (..., Q, Q) with L[i,j] = sum_{j<k<=i} dA_k for j<=i,
    -inf above the diagonal (log-space intra-chunk decay)."""
    Q = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]        # sum_(j,i]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, init_state=None):
    """Chunked SSD scan.

    xh (B,S,H,P); dt (B,S,H) (already softplus'ed, >= 0); A (H,)
    (negative); Bm/Cm (B,S,N).  Returns y (B,S,H,P) in xh's dtype,
    final_state (B,H,P,N) float32.  S must be a multiple of
    Q = min(128, S), as in the reference."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"SSD: sequence length {S} is not a multiple of "
                         f"the chunk {Q}")
    nc = S // Q

    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    dA = dtc * A.to(f32)                                # (B,nc,Q,H), <= 0
    dAh = torch.movedim(dA, -1, 2)                      # (B,nc,H,Q)
    cum = torch.cumsum(dAh, dim=-1)                     # (B,nc,H,Q)
    total = cum[..., -1]                                # (B,nc,H)

    # ---- intra-chunk (quadratic, attention-like) ----
    L = torch.exp(_segsum(dAh))                         # (B,nc,H,Q,Q)
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    xdt = xc.to(f32) * dtc[..., None]                   # (B,nc,Q,H,P)
    y_intra = torch.einsum("bchqs,bcqs,bcshp->bcqhp", L, CB, xdt)
    # ---- chunk summary states: sum_s exp(cum_end - cum_s) B_s (x) xdt_s
    decay_to_end = torch.exp(total[..., None] - cum)   # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_to_end, Bc, xdt)

    # ---- inter-chunk recurrence over nc: the state BEFORE each chunk ----
    h = (xh.new_zeros((Bsz, H, P, N), dtype=f32) if init_state is None
         else init_state.to(f32))
    prev = []
    decay = torch.exp(total)
    for c in range(nc):
        prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, 1)                         # (B,nc,H,P,N)

    # ---- inter-chunk output: y += C_q . exp(cum_q) h_prev ----
    y_inter = torch.einsum("bcqn,bchq,bchpn->bcqhp", Cc, torch.exp(cum),
                           prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), h


def ssd_scan_ref(xh, dt, A, Bm, Cm, init_state=None):
    """Token-by-token reference recurrence (the tests' oracle)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = (xh.new_zeros((Bsz, H, P, N), dtype=f32) if init_state is None
         else init_state.to(f32))
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)
        dA = torch.exp(dt_t * A.to(f32))                         # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, xh[:, t].to(f32),
                           Bm[:, t].to(f32))
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].to(f32), h))
    return torch.stack(ys, 1).to(xh.dtype), h


def _split_proj(x, p):
    """The five input projections: z, x, B, C, dt (raw)."""
    return (_proj(x, p["w_z"]), _proj(x, p["w_x"]), _proj(x, p["w_B"]),
            _proj(x, p["w_C"]), _proj(x, p["w_dt"]))


def _gated_out(y, z, p, cfg):
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    return torch.einsum("bsf,fd->bsd", y, p["w_out"])


def ssm_forward(x, p, cfg, init_state=None, conv_states=None):
    """Full-sequence Mamba-2 block. x (B,S,d_model) -> same shape.

    Returns (y, (ssm_state, {"x", "B", "C"} conv states)) so prefill can
    hand the state to the decoder."""
    Bsz, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, Bm, Cm, dt = _split_proj(x, p)

    cs = conv_states or {"x": None, "B": None, "C": None}
    xin, cs_x = _conv1d_causal(xin, p["conv_x"], cs["x"])
    Bm, cs_B = _conv1d_causal(Bm, p["conv_B"], cs["B"])
    Cm, cs_C = _conv1d_causal(Cm, p["conv_C"], cs["C"])
    xin, Bm, Cm = silu(xin), silu(Bm), silu(Cm)

    xh = xin.reshape(Bsz, S, H, P)
    dt = softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))

    y, state = ssd_chunked(xh, dt, A, Bm, Cm, init_state)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    out = _gated_out(y.reshape(Bsz, S, H * P), z, p, cfg)
    return out, (state, {"x": cs_x, "B": cs_B, "C": cs_C})


def init_ssm_state(cfg, batch, dtype=torch.float32, device="cuda"):
    """One layer's decode state on ``device``: the (B, H, P, N) SSM state
    in float32, the conv states (last W-1 inputs) in ``dtype``; keys in
    sorted order."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W = cfg.ssm_conv_width

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"conv_B": zeros((batch, W - 1, N), dtype),
            "conv_C": zeros((batch, W - 1, N), dtype),
            "conv_x": zeros((batch, W - 1, cfg.d_inner), dtype),
            "ssm": zeros((batch, H, P, N), f32)}


def ssm_decode_step(x1, p, cfg, state):
    """Single-token step. x1 (B,1,d_model); state as ``init_ssm_state``.

    Returns (y (B,1,d_model), new state); O(1) in context length."""
    Bsz = x1.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, Bm, Cm, dt = _split_proj(x1, p)

    xin, cx = _conv1d_causal(xin, p["conv_x"], state["conv_x"])
    Bm, cB = _conv1d_causal(Bm, p["conv_B"], state["conv_B"])
    Cm, cC = _conv1d_causal(Cm, p["conv_C"], state["conv_C"])
    xin, Bm, Cm = silu(xin), silu(Bm), silu(Cm)

    xh = xin.reshape(Bsz, 1, H, P)[:, 0]                     # (B,H,P)
    dt = softplus(dt.to(f32) + p["dt_bias"].to(f32))[:, 0]   # (B,H)
    A = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt * A)                                   # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh.to(f32),
                       Bm[:, 0].to(f32))
    h = state["ssm"].to(f32) * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), h)
    y = y.to(x1.dtype) + xh * p["D"].to(x1.dtype)[None, :, None]
    out = _gated_out(y.reshape(Bsz, 1, H * P), z, p, cfg)
    return out, {"conv_B": cB, "conv_C": cC, "conv_x": cx, "ssm": h}
