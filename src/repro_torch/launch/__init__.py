"""Launch entry points of the port: LM training (`python -m repro_torch.launch.train`)
and serving (`python -m repro_torch.launch.serve`)."""
