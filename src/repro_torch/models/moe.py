"""Token-choice top-k MoE with sort-based capacity dispatch.

Counterpart of ``repro.models.moe``.  The dispatch avoids a dense
(tokens, experts, capacity) one-hot by sorting the token -> expert
assignments and scatter/gathering into an (experts, capacity, d_model)
buffer:

  1. router top-k per token in float32, gates renormalized;
  2. the flat (T*k,) assignments argsorted by expert id (stable: the
     order within an expert decides which tokens are dropped);
  3. position within the expert from a ``searchsorted`` prefix; tokens
     past the capacity C = T*k/E * capacity_factor (at least 8, a
     multiple of 8) are DROPPED through a trailing dump row;
  4. the batched expert SwiGLU over (E, C, d), then the gated combine.

The dispatch scatter is out of place (``index_put`` into fresh zeros)
and the combine a gather, so ``torch.func``'s ``vmap`` of ``jvp`` of
``grad`` runs through the block.  The dump row takes the duplicate writes
of the dropped assignments and is sliced off, so a dropped token gets zero
gradient, as in the reference; every other row is written once, so the
block is deterministic on the card.  A Switch-style load-balancing loss is returned beside
the output.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models.common import silu

__all__ = ["moe_block", "router_topk", "capacity", "record_drops"]

_DROPS: list | None = None


def capacity(T: int, cfg) -> int:
    """Slots per expert for T tokens: the reference's float expression,
    in the same order, rounded up to a multiple of 8, at least 8."""
    C = int(T * cfg.experts_per_token / cfg.num_experts
            * cfg.capacity_factor)
    return max(8, -(-C // 8) * 8)


def router_probs(x2d, w_router):
    """x2d (T, d) -> the router's softmax (T, E) in float32."""
    logits = torch.einsum("td,de->te", x2d.float(), w_router.float())
    return torch.softmax(logits, dim=-1)


def topk_gates(probs, k):
    """The top-k experts of each token: gates (T, k) renormalized to sum
    1, expert ids (T, k)."""
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def switch_aux(probs, idx):
    """Switch aux loss: E * sum_e (share of assignments to e) * (mean
    probability of e)."""
    E = probs.shape[-1]
    flat = idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device)) / idx.numel()
    return E * torch.sum(probs.mean(0) * ce)


def router_topk(x2d, w_router, k):
    """x2d (T, d) -> gates (T, k) float32, idx (T, k), aux loss scalar."""
    probs = router_probs(x2d, w_router)
    gates, idx = topk_gates(probs, k)
    return gates, idx, switch_aux(probs, idx)


@contextlib.contextmanager
def record_drops():
    """Within the block, every dispatch appends (dropped, assigned) to the
    yielded list: a 0-d tensor of the (token, expert) assignments past
    their expert's capacity (no host sync) and the count of assignments.
    Only the experts the dispatch runs are counted (a shard's own)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def dispatch_combine(x2d, gates, idx, w_gate, w_up, w_down, C, e0=0):
    """Run experts e0 .. e0 + E_loc - 1 (E_loc = w_gate.shape[0]) on the
    tokens routed to them: scatter into the (E_loc * C + 1, d) buffer,
    batched SwiGLU, gate-weighted combine.  Returns (T, d); assignments to
    other experts or past capacity C contribute nothing.

    The slots come from the reference's sort; the data moves in the
    assignments' own order (token t's j-th expert is row t*k + j), so the
    combine is a gather and a sum over each token's k rows, in a fixed
    order (a scatter-add would sum them in the order atomics land)."""
    T, d = x2d.shape
    k = idx.shape[-1]
    E_loc = w_gate.shape[0]
    dev = x2d.device
    flat_e = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # the reference's searchsorted(sorted_e, arange(E))[sorted_e]: the
    # first index of each assignment's expert in the sorted order
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.empty_like(order)
    pos_in_e[order] = torch.arange(T * k, device=dev) - first
    local_e = flat_e - e0
    ours = (local_e >= 0) & (local_e < E_loc)
    mine = ours & (pos_in_e < C)
    slot = torch.where(mine, local_e * C + pos_in_e, E_loc * C)
    if _DROPS is not None:
        _DROPS.append(((ours & ~mine).sum(), int(T * k)))

    # dispatch: one trailing dump row absorbs the drops
    buf = x2d.new_zeros((E_loc * C + 1, d)).index_put(
        (slot,), x2d.repeat_interleave(k, dim=0))
    xb = buf[:-1].reshape(E_loc, C, d)

    g = torch.einsum("ecd,edf->ecf", xb, w_gate)
    u = torch.einsum("ecd,edf->ecf", xb, w_up)
    yb = torch.einsum("ecf,efd->ecd", silu(g) * u, w_down)

    # combine: gather back, weight by gate, sum each token's k rows
    ybf = torch.cat([yb.reshape(E_loc * C, d), yb.new_zeros((1, d))], 0)
    contrib = ybf.index_select(0, slot) * gates.reshape(-1, 1).to(yb.dtype)
    return torch.where(mine[:, None], contrib, 0.0).reshape(T, k, d).sum(1)


def moe_block(x2d, params, cfg, mesh=None):
    """x2d (T, d_model) -> ((T, d_model), aux loss).

    params: {"router": (d, E), "w_down": (E, ff, d), "w_gate": (E, d, ff),
             "w_up": (E, d, ff)}.  ``mesh`` is the reference's argument (its
    sharding hints are not needed here)."""
    gates, idx, aux = router_topk(x2d, params["router"],
                                  cfg.experts_per_token)
    y = dispatch_combine(x2d, gates, idx, params["w_gate"], params["w_up"],
                         params["w_down"], capacity(x2d.shape[0], cfg))
    return y, aux
