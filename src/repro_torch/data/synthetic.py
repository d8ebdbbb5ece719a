"""Deterministic, step-keyed synthetic token pipeline.

Counterpart of ``repro.data.synthetic``.  Every batch is a pure function of
(seed, step, global row), so a restart at step k reproduces the exact
token stream with NO pipeline state to checkpoint -- the data side of
fault tolerance.  The draws are numpy's, seeded as the reference seeds
them, so the port's token ids (and the VLM patches and audio frames of
``global_batch_at``) equal the reference's exactly.

The token distribution is a Zipf-like categorical, which keeps the xent
landscape non-degenerate for optimizer tests.  Batches are int64 tensors
(the index dtype of the port's gathers) on ``device``: the card unless the
caller asks for the CPU.  Given a ``parallel.sharding.NamedSharding``,
``batch_at`` makes only this rank's rows (``_tokens_np`` of their global
row ids) and returns them as a DTensor on the sharding's mesh: the
counterpart of ``jax.make_array_from_callback``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticTokens", "global_batch_at"]


@dataclass
class SyntheticTokens:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2
    device: str = "cuda"

    def _tokens_np(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Rows of the global batch (deterministic per (seed, step, row))."""
        out = np.empty((len(rows), self.seq), np.int64)
        for i, r in enumerate(rows):
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + step * 997 + int(r)) % (2 ** 31))
            z = rng.zipf(self.zipf_a, size=self.seq).astype(np.int64)
            out[i] = z % self.vocab_size
        return out

    def batch_at(self, step: int, sharding=None):
        """The global (batch, seq) int64 batch of ``step`` on the device,
        or, given a sharding, a DTensor of which this rank made only its
        own block."""
        if sharding is None:
            return torch.from_numpy(
                self._tokens_np(step, np.arange(self.batch))).to(self.device)
        shape = (self.batch, self.seq)
        rows, cols = sharding.local_slices(shape)
        data = self._tokens_np(step, np.arange(self.batch)[rows])[:, cols]
        return sharding.wrap(torch.from_numpy(data).to(self.device), shape)


def global_batch_at(cfg, shape, step: int, mesh=None, sharding=None,
                    seed: int = 0, device="cuda"):
    """Batch dict matching ``models.model.input_specs(cfg, shape)``
    for train shapes, on ``device``; the tokens sharded by ``sharding``
    when one is given (``mesh`` is the reference's, unused there too)."""
    ds = SyntheticTokens(cfg.vocab_size, shape.global_batch, shape.seq_len,
                         seed, device=device)
    toks = ds.batch_at(step, sharding)
    batch = {"tokens": toks}
    if cfg.frontend == "vlm":
        batch["tokens"] = toks[:, : shape.seq_len - cfg.frontend_len]
        rng = np.random.RandomState(seed + step)
        batch["patches"] = torch.from_numpy(
            rng.randn(shape.global_batch, cfg.frontend_len,
                      cfg.d_model).astype(np.float32)).to(device)
    elif cfg.frontend == "audio":
        rng = np.random.RandomState(seed + step)
        batch["frames"] = torch.from_numpy(
            rng.randn(shape.global_batch, cfg.frontend_len,
                      cfg.d_model).astype(np.float32)).to(device)
    return batch
