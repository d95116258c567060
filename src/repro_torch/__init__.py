"""repro_torch — the PyTorch / CUDA port of `repro`, for NVIDIA Hopper.

The port runs the JAX package's solver on an H100 through kernels written
by hand in CUDA C++.  It imports nothing of JAX or of `repro`.

    from repro_torch.api import SolverConfig, plan
    fact = plan(N, SolverConfig()).execute(A)   # on the CUDA card
    x = fact.solve(b)

Entry points run on the card unless the caller passes `device="cpu"`, where
the kernels' plain PyTorch versions run instead.

    repro_torch.api              — plan/execute solver surface (plan(N), plan((B, N)))
    repro_torch.core.lu          — masked sequential LU, single and batched; the
                                   2.5D COnfLUX schedule, the 2D baseline, the
                                   grid optimizer and the comm-volume counters
    repro_torch.core.cholesky    — blocked Cholesky, sequential and 2.5D
    repro_torch.core.collectives — the process mesh (px, py, pz) on torch.distributed
    repro_torch.core.solve       — lu_solve over raw packed factors
    repro_torch.kernels          — CUDA kernels, wrappers, plain versions, backends
    repro_torch.serving          — SolveEngine, AsyncSolveEngine
    repro_torch.interop          — factors and configs from the JAX package
"""

__version__ = "0.1.0"
