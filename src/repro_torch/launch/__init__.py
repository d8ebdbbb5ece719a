"""repro_torch.launch -- entry points (counterpart of ``repro.launch``):
``python -m repro_torch.launch.serve`` runs the curvature server,
``python -m repro_torch.launch.train`` the single-device trainer."""
