"""repro_torch.data -- the step-keyed synthetic token pipeline (counterpart
of ``repro.data``)."""

from repro_torch.data.synthetic import SyntheticTokens, global_batch_at

__all__ = ["SyntheticTokens", "global_batch_at"]
