"""repro_torch.models -- the dense LM: forward and loss, prefill and decode
against KV caches (bfloat16 or int8), the continuous-batching decode
engine, and the curvature targets built on the forward.  Counterpart of
``repro.models``; the other families wait for ROADMAP A.7."""
