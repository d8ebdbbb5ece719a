"""repro_torch.models -- the LM zoo's dense, MoE, SSM and hybrid families:
forward and loss, prefill and decode against KV caches (bfloat16 or int8)
and SSM states, the continuous-batching decode engine, and the curvature
targets built on the forward.  Counterpart of ``repro.models``; the
enc-dec and VLM families wait for ROADMAP A.7."""
