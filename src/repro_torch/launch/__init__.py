"""repro_torch.launch -- entry points; ``python -m repro_torch.launch.serve``
runs the curvature server (counterpart of ``repro.launch``)."""
