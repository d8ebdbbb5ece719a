"""repro_torch.models -- the LM zoo's dense, MoE, SSM, hybrid, enc-dec
and VLM families: forward and loss (each layer recomputed in the backward
under ``cfg.remat``), prefill and decode against KV caches (bfloat16 or
int8), SSM states and the enc-dec cross cache, the continuous-batching
decode engine, and the curvature targets built on the forward.
Counterpart of ``repro.models``."""
