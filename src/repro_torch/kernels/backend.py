"""KernelBackend — pluggable local-compute primitives for the factorizations.

The schedules spend essentially all their FLOPs in a few local primitives
(paper Algorithm 1): the masked panel LUP, the triangular solves, and the
rank-v Schur update.  A `KernelBackend` packages one implementation of them,
and the schedules call the backend instead of inlining tensor math.

Two backends are registered:

- "cuda" (the default): the hand-written Hopper kernels on CUDA tensors, and
  their plain versions on CPU tensors.  It never falls back: a plan the
  kernels cannot run is refused at resolve time (`check_hopper_constraints`).
- "ref": plain PyTorch on any device.

Every primitive of the protocol is ported, single and batched, in f32,
f64, bf16 and f16 (`KERNEL_DTYPES`).  A primitive given sub-4-byte inputs
(bf16, f16) computes in f32 and rounds its result once on the way out, on
both backends, as the TPU kernels did with their f32 scratch.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.kernels import ops, ref

# What the kernels take: the element types of each primitive (its batched
# form takes the same), the panel widths their shared-memory buffers hold,
# and the systems one batched launch covers (the fused kernel puts them on
# gridDim.z).
_ALL = ("float32", "float64", "bfloat16", "float16")
KERNEL_DTYPES = {
    "panel_lup": _ALL,
    "fused_trsm_schur": _ALL,
    "panel_chol": _ALL,
    "trsm_right_upper": _ALL,
    "trsm_left_lower": _ALL,
    "schur_update": _ALL,
}
MAX_PANEL_WIDTH = 128
MAX_BATCH = 65535


@runtime_checkable
class KernelBackend(Protocol):
    """The paper's local compute primitives, one method each, on tensors."""

    name: str

    def panel_lup(self, panel: torch.Tensor, weights: torch.Tensor, v: int):
        """Masked LUP of an [R, v] panel; rows with weight 0 are untouched
        (unless a pivot row holds inf or NaN, which spreads to every row).

        Returns (F [R, v] packed factors, order [v] int32 pivot rows,
        ok [v] bool validity)."""
        ...

    def panel_chol(self, A: torch.Tensor) -> torch.Tensor:
        """Lower Cholesky factor of an SPD diagonal block A [v, v] = L L^T."""
        ...

    def trsm_right_upper(self, B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """X U = B  ->  X = B U^-1.  B [R, v], U [v, v] upper (L10, step 4)."""
        ...

    def trsm_left_lower(self, L: torch.Tensor, B: torch.Tensor, *,
                        unit: bool = True) -> torch.Tensor:
        """L X = B  ->  X = L^-1 B.  L [v, v] (unit-)lower, B [v, C] (U01, step 5)."""
        ...

    def schur_update(self, A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """A - L @ U.  A [M, N], L [M, K], U [K, N] (rank-v update, step 6)."""
        ...

    def fused_trsm_schur(self, A: torch.Tensor, L00: torch.Tensor, R01: torch.Tensor,
                         L10: torch.Tensor, *, unit: bool = True):
        """Steps 5+6 fused: U01 = L00^-1 R01, then A - L10 @ U01.

        Returns (A_new, U01), out of place."""
        ...

    # Batched variants: one leading batch axis, B independent systems.

    def panel_lup_batched(self, panel, weights, v: int):
        """Masked LUP of B panels [B, R, v]."""
        ...

    def panel_chol_batched(self, A):
        """Lower Cholesky factors of B SPD blocks A [B, v, v]."""
        ...

    def trsm_right_upper_batched(self, B, U):
        """Per-system X_b U_b = B_b."""
        ...

    def trsm_left_lower_batched(self, L, B, *, unit: bool = True):
        """Per-system L_b X_b = B_b."""
        ...

    def schur_update_batched(self, A, L, U):
        """Per-system A_b - L_b @ U_b."""
        ...

    def fused_trsm_schur_batched(self, A, L00, R01, L10, *, unit: bool = True):
        """Per-system fused steps 5+6."""
        ...


_BACKENDS: dict[str, KernelBackend] = {}


def register_backend(name: str, backend: KernelBackend, *, overwrite: bool = False) -> None:
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered (pass overwrite=True)")
    _BACKENDS[name] = backend


def get_backend(name: str) -> KernelBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def check_hopper_constraints(dtype: str, v: int | None, B: int | None = None,
                             primitives=tuple(KERNEL_DTYPES)) -> None:
    """Raise ValueError unless the "cuda" kernels can run this plan.

    `primitives` are the ones the plan's strategy calls.  Each takes the
    dtypes of `KERNEL_DTYPES` (f32, f64 native on Hopper, bf16 and f16
    computed in f32), panel widths up to `MAX_PANEL_WIDTH` and batches of up
    to `MAX_BATCH` systems.  Anything else is refused, never sent to another
    backend.
    """
    missing = [p for p in primitives if dtype not in KERNEL_DTYPES[p]]
    if missing:
        raise ValueError(
            f"backend 'cuda' has no {dtype} kernel for {', '.join(missing)}: "
            f"it takes {', '.join(KERNEL_DTYPES[missing[0]])}"
        )
    if v is not None and not 1 <= v <= MAX_PANEL_WIDTH:
        raise ValueError(
            f"backend 'cuda' takes panel widths 1..{MAX_PANEL_WIDTH}, got v={v}"
        )
    if B is not None and B > MAX_BATCH:
        raise ValueError(
            f"backend 'cuda' factorizes at most {MAX_BATCH} systems per batched plan, "
            f"got B={B}; split the stack"
        )


class RefBackend:
    """Plain PyTorch primitives on any device (`repro_torch.kernels.ref`).
    Sub-4-byte inputs are upcast to f32 per primitive and rounded back on
    the way out."""

    name = "ref"

    def panel_lup(self, panel, weights, v):
        return ref.lu_panel(panel, weights)

    def panel_chol(self, A):
        return ref.chol_panel(A)

    def trsm_right_upper(self, B, U):
        return ref.trsm_right_upper(B, U)

    def trsm_left_lower(self, L, B, *, unit=True):
        return ref.trsm_left_lower(L, B, unit=unit)

    def schur_update(self, A, L, U):
        return ref.schur_update(A, L, U)

    def fused_trsm_schur(self, A, L00, R01, L10, *, unit=True):
        return ref.fused_trsm_schur(A, L00, R01, L10, unit=unit)

    # Batched: the batch axis written out; a lane equals the single call.

    def panel_lup_batched(self, panel, weights, v):
        return ref.lu_panel_batched(panel, weights)

    def panel_chol_batched(self, A):
        return ref.chol_panel_batched(A)

    def trsm_right_upper_batched(self, B, U):
        return ref.trsm_right_upper_batched(B, U)

    def trsm_left_lower_batched(self, L, B, *, unit=True):
        return ref.trsm_left_lower_batched(L, B, unit=unit)

    def schur_update_batched(self, A, L, U):
        return ref.schur_update_batched(A, L, U)

    def fused_trsm_schur_batched(self, A, L00, R01, L10, *, unit=True):
        return ref.fused_trsm_schur_batched(A, L00, R01, L10, unit=unit)


class CudaBackend:
    """The hand-written Hopper kernels (`repro_torch.kernels.ops`).  CPU
    tensors run the kernels' plain versions."""

    name = "cuda"

    def panel_lup(self, panel, weights, v):
        return ops.lu_panel(panel, weights)

    def panel_chol(self, A):
        return ops.chol_panel(A)

    def trsm_right_upper(self, B, U):
        return ops.trsm_right_upper(B, U)

    def trsm_left_lower(self, L, B, *, unit=True):
        return ops.trsm_left_lower(L, B, unit=unit)

    def schur_update(self, A, L, U):
        return ops.schur_update(A, L, U)

    def fused_trsm_schur(self, A, L00, R01, L10, *, unit=True):
        return ops.fused_trsm_schur(A, L00, R01, L10, unit=unit)

    # Batched: one launch per step covers all B systems.

    def panel_lup_batched(self, panel, weights, v):
        return ops.lu_panel_batched(panel, weights)

    def panel_chol_batched(self, A):
        return ops.chol_panel_batched(A)

    def trsm_right_upper_batched(self, B, U):
        return ops.trsm_right_upper_batched(B, U)

    def trsm_left_lower_batched(self, L, B, *, unit=True):
        return ops.trsm_left_lower_batched(L, B, unit=unit)

    def schur_update_batched(self, A, L, U):
        return ops.schur_update_batched(A, L, U)

    def fused_trsm_schur_batched(self, A, L00, R01, L10, *, unit=True):
        return ops.fused_trsm_schur_batched(A, L00, R01, L10, unit=unit)


register_backend("ref", RefBackend())
register_backend("cuda", CudaBackend())
