"""Launch entry points of the port: LM serving (`python -m repro_torch.launch.serve`)."""
