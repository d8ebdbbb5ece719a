"""Token-decode engine: slot-based continuous batching over the decode step
of the LM model zoo (dense, MoE, SSM, hybrid and VLM families; a VLM's
requests are text-only, as the reference's engine serves them).  An
enc-dec config is refused: a request carries tokens only, and whisper's
prefill needs the audio frames (the reference's engine prefills with
``{"tokens": ...}`` and fails there too).

Counterpart of ``repro.models.decode_engine``.  A fixed pool of
``max_batch`` slots shares one decode state.  Requests queue up; free
slots are prefilled one request at a time (prefill is full-sequence), and
then all active slots decode in lockstep, each with its own position.
Greedy or temperature sampling.  A slot frees as soon as its request ends
(EOS or ``max_new_tokens``, a token produced by the prefill included) and
the queue refills it, so tokens keep flowing at batch occupancy.

A slot's prefill resets that slot in every leaf of the decode state first
(``pos`` to -1, everything else, k/v and the SSM and conv states, to 0:
nothing of the previous occupant reaches the new request) and writes the
prompt's caches and states into the slot's view of the shared state, in
place; the engine never re-allocates them.  Everything runs under
``torch.inference_mode()``: no autograd graph is built against the params.

Differences by design from the reference: greedy sampling is the same
``argmax`` (the first maximum), but temperature sampling draws from a
``torch.Generator`` on the engine's device seeded by ``seed``, which does
not reproduce ``jax.random.categorical``'s stream.  ``keep_logits=True``
on ``submit`` keeps each emitted token's float32 logits on the host (the
reference keeps none).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.models.model import (decode_step, forward,
                                      init_decode_state)

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: list = field(default_factory=list)
    done: bool = False
    keep_logits: bool = False
    out_logits: list = field(default_factory=list)   # (V,) float32 tensors


def _slot_views(tree, slot, name=""):
    """Every leaf's view of batch row ``slot`` (leaves are (n, B, ...)),
    reset in place: ``pos`` to -1, everything else to 0."""
    if isinstance(tree, dict):
        return {k: _slot_views(v, slot, k) for k, v in tree.items()}
    view = tree[:, slot:slot + 1]
    view.fill_(-1 if name == "pos" else 0)
    return view


class ServingEngine:
    def __init__(self, params, cfg, *, max_batch: int = 4,
                 max_seq: int = 512, mesh=None, temperature: float = 0.0,
                 seed: int = 0, cache_dtype=torch.bfloat16, device="cuda"):
        """``params`` must lie on ``device`` (the card unless the caller
        asks for the CPU).  ``cache_dtype`` is the dtype of the k/v caches
        and the SSM conv states (the reference's fixed bfloat16 by
        default); ``cfg.kv_cache_dtype == "int8"`` quantizes the k/v
        caches instead."""
        if cfg.family == "encdec":
            raise ValueError(
                f"ServingEngine: {cfg.name} is an encoder-decoder; its "
                "prefill needs the audio frames, and a request carries "
                "tokens only (use model.prefill / decode_step)")
        self.device = torch.device(device)
        where = {leaf.device for leaf in pytree.tree_leaves(params)}
        if any(d.type != self.device.type for d in where):
            raise ValueError(f"ServingEngine on {self.device}: the params "
                             f"lie on {sorted(map(str, where))}")
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.B, self.S = max_batch, max_seq
        with torch.inference_mode():
            self.state = init_decode_state(cfg, max_batch, max_seq,
                                           dtype=cache_dtype,
                                           device=self.device)
        self.pos = np.zeros((max_batch,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._next_rid = 0

    # -- public API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               keep_logits=False) -> Request:
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_id, keep_logits=keep_logits)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until queue and slots drain. Returns finished requests."""
        with torch.inference_mode():
            return self._run(max_steps)

    # -- internals ----------------------------------------------------------
    def _run(self, max_steps):
        self._finished: list[Request] = []
        finished = self._finished
        last_token = np.zeros((self.B,), np.int32)
        for _ in range(max_steps):
            self._fill_slots(last_token)
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                if self.queue:      # slots freed at prefill-time EOS
                    continue
                break
            toks = torch.as_tensor(last_token[:, None], device=self.device)
            pos = torch.as_tensor(self.pos, device=self.device)
            logits, self.state = decode_step(self.params, self.cfg, toks, pos,
                                             self.state, self.mesh)
            nxt = self._sample(logits)
            for i in active:
                req = self.slot_req[i]
                tok = int(nxt[i])
                req.out_tokens.append(tok)
                if req.keep_logits:
                    req.out_logits.append(logits[i].float().cpu())
                last_token[i] = tok
                self.pos[i] += 1
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self.slot_req[i] = None
        return finished

    def _sample(self, logits) -> np.ndarray:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _prefill_into(self, tokens, slot):
        """Reset slot ``slot`` of the shared state, prefill ``tokens`` (1, S)
        into it in place; the last position's logits (1, V)."""
        sub = _slot_views(self.state, slot)
        logits, _, _ = forward(self.params, self.cfg, {"tokens": tokens},
                               self.mesh, mode="prefill", state=sub)
        return logits[:, -1]

    def _fill_slots(self, last_token: np.ndarray):
        for i in range(self.B):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                toks = torch.as_tensor(req.prompt[None, :],
                                       device=self.device)
                logits = self._prefill_into(toks, i)
                nxt = int(self._sample(logits)[0])
                req.out_tokens.append(nxt)
                if req.keep_logits:
                    req.out_logits.append(logits[0].float().cpu())
                # the prefill-produced token can already terminate
                if (req.eos_id is not None and nxt == req.eos_id) or \
                        req.max_new_tokens <= 1:
                    req.done = True
                    self._finished.append(req)
                    continue
                last_token[i] = nxt
                self.pos[i] = len(req.prompt)
                self.slot_req[i] = req
