"""repro_torch.models -- the dense LM forward and loss in train mode, and
the curvature targets built on it.  Counterpart of ``repro.models``; the
other families, decode and training wait for ROADMAP A.7."""
