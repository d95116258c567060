"""Launch entry points of the port: LM training (`python -m repro_torch.launch.train`),
serving (`python -m repro_torch.launch.serve`), and the dry-run tools on the meta
device (`python -m repro_torch.launch.dryrun`, `python -m repro_torch.launch.perf`,
with `launch.mesh` and `launch.specs`)."""
