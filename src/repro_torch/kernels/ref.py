"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, on any device.  The kernel
wrappers use them for CPU tensors, the CPU tests hold them against the JAX
package, and `chip_smoke.py` holds each kernel against its plain version on
the card.  Sub-4-byte inputs compute in f32 and round back, as the TPU
kernels did.
"""

from __future__ import annotations

import torch

from repro_torch.core.lu.sequential import masked_lup, masked_lup_batched


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.element_size() < 4 else t.dtype


def lu_panel(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of panel [R, v] with candidate weights [R].

    Returns (F [R, v] in the panel's dtype, order [v] int32, ok [v] bool).
    """
    wd = _work_dtype(panel)
    F, order, ok = masked_lup(panel.to(wd), weights.to(wd), panel.shape[1])
    return F.to(panel.dtype), order, ok


def lu_panel_batched(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of B panels [B, R, v] with weights [B, R].

    Returns (F [B, R, v], order [B, v] int32, ok [B, v] bool); lane b equals
    `lu_panel(panel[b], weights[b])` bit for bit.
    """
    wd = _work_dtype(panel)
    F, order, ok = masked_lup_batched(panel.to(wd), weights.to(wd), panel.shape[-1])
    return F.to(panel.dtype), order, ok


def fused_trsm_schur(A, L00, R01, L10, unit: bool = True):
    """(A - L10 @ U01, U01) with U01 = L00^-1 R01 (L00 unit-lower if `unit`).

    Out of place, as the kernel: A is not modified.
    """
    wd = _work_dtype(A)
    U01 = torch.linalg.solve_triangular(
        L00.to(wd), R01.to(wd), upper=False, unitriangular=unit
    )
    return (A.to(wd) - L10.to(wd) @ U01).to(A.dtype), U01.to(R01.dtype)


# The batched form [B, M, C], [B, v, v], [B, v, C], [B, M, v] is the same
# code: `solve_triangular` and `@` broadcast over the leading batch axis.
fused_trsm_schur_batched = fused_trsm_schur


def chol_panel_batched(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of B SPD blocks A [B, v, v], upper triangles zeroed.

    The v rounds of the TPU kernel (`_chol_rounds`) with the batch axis
    written out: d = sqrt(A[k, k]); l = A[:, k] / d below the diagonal, 0
    elsewhere; column k becomes l + d e_k; then the whole block takes
    A - l l^T.  The divisor stays a device tensor (CUDA divides by a host
    scalar through its reciprocal, which rounds differently), and every
    operation runs on the full block, so a NaN pivot spreads exactly as in
    the kernel.  A block that is not SPD gives non-finite values and never
    raises (no `torch.linalg.cholesky`, whose error check syncs the host).
    The kernel rounds the same operations in the same order, so the two
    agree bit for bit.
    """
    wd = _work_dtype(A)
    F = A.to(wd).clone()
    v = F.shape[-1]
    ridx = torch.arange(v, device=F.device)
    for k in range(v):
        d = torch.sqrt(F[:, k, k])[:, None]
        col = F[:, :, k] / d
        l = torch.where(ridx > k, col, torch.zeros_like(col))
        F[:, :, k] = l + d * (ridx == k).to(wd)
        F = F - l[:, :, None] * l[:, None, :]
    return torch.tril(F).to(A.dtype)


def chol_panel(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one SPD block A [v, v]: the batch of one of
    `chol_panel_batched`."""
    return chol_panel_batched(A[None])[0]


def trsm_right_upper(B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """X = B U^-1 for B [R, v] and U [v, v] upper (non-unit), or per system
    for B [Bb, R, v] and U [Bb, v, v]."""
    wd = _work_dtype(B)
    X = torch.linalg.solve_triangular(U.to(wd), B.to(wd), upper=True, left=False)
    return X.to(B.dtype)


trsm_right_upper_batched = trsm_right_upper


def trsm_left_lower(L: torch.Tensor, B: torch.Tensor, unit: bool = True) -> torch.Tensor:
    """X = L^-1 B for L [v, v] lower (unit diagonal if `unit`) and B [v, C],
    or per system for L [Bb, v, v] and B [Bb, v, C]."""
    wd = _work_dtype(B)
    X = torch.linalg.solve_triangular(L.to(wd), B.to(wd), upper=False, unitriangular=unit)
    return X.to(B.dtype)


trsm_left_lower_batched = trsm_left_lower


def schur_update(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """A - L @ U for A [M, N], L [M, K], U [K, N], or per system for
    [B, M, N], [B, M, K], [B, K, N]; f32 accumulation for sub-4-byte inputs."""
    wd = _work_dtype(A)
    return (A.to(wd) - L.to(wd) @ U.to(wd)).to(A.dtype)


schur_update_batched = schur_update


NEG_INF = -1e30  # the reference's finite mask value (never -inf: exp(-inf - -inf) is NaN)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense softmax GQA attention: q [B, S, H, hd], k and v [B, S, KV, hd]
    (H % KV == 0) -> [B, S, H, hd] in q's dtype.

    As the JAX package's `ref.flash_attention`: the scores come out of the
    product in the inputs' dtype and are then taken to f32 (bf16 inputs round
    them, where the kernel keeps them in f32), scaled by hd^-1/2, softcapped
    as cap * tanh(s / cap), masked with the finite NEG_INF, softmaxed in f32,
    and the probabilities are rounded to v's dtype before the PV product.
    f64 inputs keep f64 throughout (for gradient checks).

    `score_dtype=torch.bfloat16` holds the scores in bf16 where the JAX
    package's `blocked_attention(score_dtype=bf16)` holds them: the product
    taken to bf16, then each of `* scale`, `/ cap`, tanh, `cap *`, the mask
    (NEG_INF rounded to bf16), `s - max` and exp rounds to bf16 (the scale
    and the cap are bf16 constants, as JAX takes a Python float against a
    bf16 array); the sum of p is f32, the PV product takes p as it is in f32
    and divides by the sum after it.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    work = torch.promote_types(q.dtype, torch.float32)  # f64 inputs stay f64
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    if score_dtype == torch.float32:
        s = s.to(work) * hd**-0.5
    else:
        s = s.to(score_dtype) * torch.tensor(hd**-0.5, dtype=score_dtype)
    if softcap is not None:
        cap = softcap if score_dtype == torch.float32 else torch.tensor(softcap, dtype=score_dtype)
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(S, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    s = s.masked_fill(~ok, NEG_INF)
    if score_dtype != torch.float32:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = torch.einsum("bkgqs,bskh->bqkgh", p.to(work), v.to(work))
        out = out / p.to(work).sum(-1).permute(0, 3, 1, 2)[..., None]
        return out.reshape(B, S, H, hd).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd).to(q.dtype)


def mamba_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor, *,
               return_state: bool = False):
    """The selective-scan recurrence, one step at a time, in f32:

        h_t = a_t * h_{t-1} + b_t,   y_t[i] = sum_n C_t[n] h_t[i, n],   h_0 = 0,

    for a and b [B, S, di, N] and C [B, S, N].  Returns y [B, S, di], and with
    `return_state` also the last state h_S [B, di, N].  The product and the
    sum round separately (two operations, no fused multiply-add), as the
    kernel rounds them, so the two states agree bit for bit.  f64 inputs
    run in f64 (for gradient checks).
    """
    B, S, di, N = a.shape
    work = torch.promote_types(a.dtype, torch.float32)  # f64 inputs stay f64
    h = torch.zeros((B, di, N), dtype=work, device=a.device)
    y = torch.empty((B, S, di), dtype=work, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return (y, h) if return_state else y
