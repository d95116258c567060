"""Hand-written Hopper kernels for the solver's and the LM stack's hot spots.

csrc/*.cu are the CUDA C++ sources, built at first use by `_build.py` into
shared libraries with a plain C interface and loaded with ctypes.
lu_panel.py, fused_schur.py, chol_panel.py, trsm.py, schur_update.py,
flash_attention.py and mamba_scan.py are the kernels' wrappers (each counts
its launches), ref.py holds their plain PyTorch versions, ops.py the public
wrappers (auto-fit tiles where a kernel has them), and backend.py the
`KernelBackend` layer ("cuda" = the kernels, "ref" = plain PyTorch) the
factorizations call.  The LM layers pick between the two LM kernels and
their plain versions with the same two backend names.
"""
