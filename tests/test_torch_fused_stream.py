"""The bf16 / f16 stream of `fused_trsm_schur[_batched]`, on the CPU.

The stream runs only on the card (`csrc/fused_schur.cu`,
`fused_trsm_schur_wgmma_kernel`); `chip_smoke.py` holds it to its plain
version there.  What the CPU can hold:

- `stream_mode`, the launcher's rule for which body a call takes, from
  shapes, strides, dtype and addresses alone;
- the stream's exact split of each f32 value of U into three bf16 parts,
  and of each f16 value of L10 into two, modelled here with bit masks on
  `.view(torch.int32)` as the kernel forms them (`split3`, `split2`);
- the function the split computes: the sum over the parts of
  L_part @ U_part in f32, each NaN formed again from the whole values,
  subtracted from A and rounded once, against the JAX package's
  `fused_trsm_schur[_batched]` (Pallas, interpret mode) in bf16 and f16.
  Tolerance, as `chip_smoke.py` holds the kernel on the card: one ulp of the
  2-byte dtype at the larger of the two values plus FUSED_REL_TOL (1e-5) of
  the scale (the largest finite magnitude of the result and of U01): both
  sides sum exact products in f32 in another order, and rounding two f32
  sums that far apart to 2 bytes may part them by one ulp.  NaN and inf at
  JAX's places.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
from repro.kernels import ops as jops
from repro_torch.kernels.fused_schur import stream_mode

LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
FUSED_REL_TOL = 1e-5  # chip_smoke.FUSED_REL_TOL
_HI = -65536  # 0xffff0000: the bits a bf16 part keeps
_SIGN = -2**31  # 0x80000000
TINY = 2.0**-110  # below this, lo loses bits under bf16's smallest subnormal
BF16_SUB = 2.0**-133  # bf16's smallest subnormal


def split3(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's `split3` of f32 values: hi = u with its low 16 bits
    cleared, r = u - hi, mid = r with its low 16 bits cleared, lo = r - mid
    (cut to bf16's bits); every part carries u's sign.  Non-finite u: hi
    its bf16 value, mid = lo = 0."""
    b = u.view(torch.int32)
    sign = b & _SIGN
    r = u - (b & _HI).view(torch.float32)
    rb = r.view(torch.int32) & _HI
    lo = (r - rb.view(torch.float32)).view(torch.int32) | sign
    fin = torch.isfinite(u)
    zero = torch.zeros_like(b)
    parts = (torch.where(fin, b & _HI, u.to(torch.bfloat16).float().view(torch.int32)),
             torch.where(fin, rb | sign, zero), torch.where(fin, lo & _HI, zero))
    return tuple(p.view(torch.float32).to(torch.bfloat16) for p in parts)


def split2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's `split2` of f16 values: hi = the value widened to f32
    with its low 16 bits cleared, lo = value - hi, exact."""
    u = x.float()
    b = u.view(torch.int32)
    lo = (u - (b & _HI).view(torch.float32)).view(torch.int32) | (b & _SIGN)
    fin = torch.isfinite(u)
    parts = (torch.where(fin, b & _HI, u.to(torch.bfloat16).float().view(torch.int32)),
             torch.where(fin, lo & _HI, torch.zeros_like(b)))
    return tuple(p.view(torch.float32).to(torch.bfloat16) for p in parts)


def split_model(A, L00, R01, L10, unit: bool):
    """The stream's function on the CPU: U in f32, the products of the bf16
    parts of L10 (itself in bf16, two parts in f16) and of U summed in f32,
    each NaN of the sum formed again from the whole values (as the kernel
    does where a tile meets a non-finite value), A - sum rounded once."""
    U = torch.linalg.solve_triangular(L00.float(), R01.float(), upper=False, unitriangular=unit)
    l_parts = (L10,) if L10.dtype == torch.bfloat16 else split2(L10)
    S = sum(lp.float() @ up.float() for lp in l_parts for up in split3(U))
    S = torch.where(S.isnan(), L10.float() @ U, S)
    return (A.float() - S).to(A.dtype), U.to(R01.dtype)


# --------------------------------------------------------------------------
# stream_mode
# --------------------------------------------------------------------------

# The body each edge takes, by element size (2, 4, 8 bytes): the wgmma
# stream for bf16 / f16 (8 <= v <= 32) and the TMA stream for f32
# (4 <= v <= 32) where A has rows and every operand has a 16-byte aligned
# base, row and batch strides of whole 16-byte runs and rows of at least 16
# bytes; else, and always in f64, the plain loads.
_EDGES = {
    "path_shape": ("wgmma", "tma", "plain"),
    "window_v32": ("wgmma", "tma", "plain"),
    "window_v16": ("wgmma", "tma", "plain"),
    "window_v8": ("wgmma", "tma", "plain"),
    "v=1": ("plain", "plain", "plain"),
    "v=7": ("plain", "plain", "plain"),
    "v=8": ("wgmma", "tma", "plain"),
    "v=33": ("plain", "plain", "plain"),
    "v=128": ("plain", "plain", "plain"),
    "odd_row_stride": ("plain", "plain", "plain"),
    "base_one_element_in": ("plain", "plain", "plain"),
    "odd_batch_stride": ("plain", "plain", "plain"),
    "one_system_odd_batch_stride": ("wgmma", "tma", "plain"),
    "C=4": ("plain", "tma", "plain"),
    "C=300": ("plain", "tma", "plain"),
    "M=0": ("plain", "plain", "plain"),
}


def _edge_operands(edge: str, dtype: torch.dtype):
    B, M, C, v = 2, 96, 512, 32
    if edge.startswith("v="):
        v = int(edge[2:])
    elif edge.startswith("window_v"):
        v = int(edge[len("window_v"):])
    elif edge.startswith("C="):
        C = int(edge[2:])
    elif edge == "M=0":
        M = 0
    elif edge == "one_system_odd_batch_stride":
        B = 1

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype)

    A, L00, R01, L10 = zeros(B, M, C), zeros(B, v, v), zeros(B, v, C), zeros(B, M, v)
    if edge.startswith("window"):
        # as the conflux step passes A: rows 32 and columns 64 into a wider matrix
        A = zeros(B, M + 32, C + 64)[:, 32:, 64:]
    elif edge == "odd_row_stride":
        A = zeros(B, M, C + 1)[..., :C]
    elif edge == "base_one_element_in":
        R01 = zeros(B, v, C + 8)[..., 1:C + 1]
    elif edge.endswith("odd_batch_stride"):
        L10 = zeros(B * (M * v + 1)).as_strided((B, M, v), (M * v + 1, v, 1))
    return A, L00, R01, L10


@pytest.mark.parametrize("edge", list(_EDGES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.float64])
def test_fused_stream_mode_follows_the_alignment_rule(dtype, edge):
    """`stream_mode` on CPU tensors: the rule alone (the kernel that follows
    it is held to its plain version, and its mode to this prediction, on the
    card).  A single system predicts as a batch of one."""
    ops = _edge_operands(edge, dtype)
    want = _EDGES[edge][{2: 0, 4: 1, 8: 2}[ops[0].element_size()]]
    assert stream_mode(*ops) == want
    if ops[0].shape[0] == 1:
        assert stream_mode(*(t[0] for t in ops)) == want


def test_lu_paths_operands_take_the_stream():
    """The operands as `lu_masked_sequential` builds them at a step (a
    column slice of F, products with masks, a gathered row block) take the
    2-byte stream, as the paths require on the card."""
    N, v, c0 = 256, 32, 64
    for dt in (torch.bfloat16, torch.float16):
        F = torch.randn(N, N).to(dt)
        Fp = F[:, c0:c0 + v].clone()
        active = torch.ones(N, dtype=dt)
        order = torch.arange(c0, c0 + v)
        L10 = Fp * active[:, None]
        L00 = torch.tril(Fp.index_select(0, order), -1) + torch.eye(v, dtype=dt)
        R01 = F.index_select(0, order) * (torch.arange(N) >= c0 + v).to(dt)
        assert stream_mode(F, L00, R01, L10) == "wgmma"
        assert stream_mode(F[None].expand(3, N, N).contiguous(), L00.expand(3, v, v).contiguous(),
                           R01.expand(3, v, N).contiguous(),
                           L10.expand(3, N, v).contiguous()) == "wgmma"


# --------------------------------------------------------------------------
# The exact splits
# --------------------------------------------------------------------------


def _f32_from_bits(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_three_part_bf16_split_is_exact():
    """hi + mid + lo rebuilds u bit for bit wherever |u| >= 2^-110 or
    u = +-0, over 10^5 seeded bit patterns (every exponent, both signs) and
    the edges: f32's largest values (hi, a truncation, must not overflow),
    its smallest normal and subnormals.  Below 2^-110, lo drops bits under
    bf16's smallest subnormal (2^-133): the rebuilt value stays within 2^-133
    of u, far below any allowance of the kernel (FUSED_REL_TOL of the scale).
    Non-finite u goes into hi only."""
    rng = np.random.default_rng(24)
    edges = [0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8001, 0x7F7FFF01, 0x7F000000, 0x00000000, 0x80000000,
             0x00800000, 0x80800001, 0x00000001, 0x807FFFFF, 0x00012345, 0x08800000, 0x08FFFFFF,
             0x3F800001, 0xBF800001, 0x3FFFFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
             0xFFC00001]
    bits = np.concatenate([rng.integers(0, 2**32, size=100_000, dtype=np.uint64), edges])
    u = _f32_from_bits(bits)
    hi, mid, lo = split3(u)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    rebuilt = (hi.float() + mid.float()) + lo.float()
    fin = torch.isfinite(u)
    exact = fin & ((u.abs() >= TINY) | (u == 0))
    assert int(exact.sum()) > 80_000
    assert torch.equal(rebuilt[exact].view(torch.int32), u[exact].view(torch.int32))
    assert torch.isfinite(hi[fin].float()).all() and torch.isfinite(mid[fin].float()).all()
    assert torch.isfinite(lo[fin].float()).all()
    big = u.abs() >= 3.0e38
    assert int(big.sum()) >= 4 and torch.equal(rebuilt[big & fin], u[big & fin])
    tiny = fin & ~exact
    assert int(tiny.sum()) > 1000
    assert ((rebuilt[tiny].double() - u[tiny].double()).abs() < BF16_SUB).all()
    # Each part lies under the one before it: 8 + 8 + 8 significant bits.
    nz = exact & (mid.float() != 0)
    assert (mid[nz].float().abs() < hi[nz].float().abs() * 2.0**-7).all()
    # The non-finite guard: the value whole in hi, mid = lo = +0.
    nonfin = ~fin
    assert int(nonfin.sum()) > 100
    assert torch.equal(hi[nonfin].float().isnan(), u[nonfin].isnan())
    assert torch.equal(hi[u.isinf()].float(), u[u.isinf()])
    assert (mid[nonfin].view(torch.int16) == 0).all() and (lo[nonfin].view(torch.int16) == 0).all()


def test_two_part_split_of_every_f16_value_is_exact():
    """hi + lo rebuilds every finite f16 value bit for bit (as f32), the
    subnormals and both zeros included: f16 has 11 significant bits, hi
    keeps 8 and lo = value - hi the rest.  inf and NaN go into hi only."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.float16)
    hi, lo = split2(x)
    fin = torch.isfinite(x)
    assert int(fin.sum()) == 2**16 - 2048
    rebuilt = hi.float() + lo.float()
    assert torch.equal(rebuilt[fin].view(torch.int32), x[fin].float().view(torch.int32))
    assert torch.equal(hi[~fin].float().isnan(), x[~fin].isnan())
    assert torch.equal(hi[x.isinf()].float(), x[x.isinf()].float())
    assert (lo[~fin].view(torch.int16) == 0).all()


# --------------------------------------------------------------------------
# The split's function against the JAX kernel
# --------------------------------------------------------------------------


def _inputs(case: str, lead: tuple, M: int, C: int, v: int, unit: bool, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((*lead, M, C)).astype(np.float32)
    L00 = (0.3 * np.tril(rng.standard_normal((*lead, v, v)), -1)
           + (1.0 if unit else 2.0) * np.eye(v)).astype(np.float32)
    R01 = rng.standard_normal((*lead, v, C)).astype(np.float32)
    L10 = rng.standard_normal((*lead, M, v)).astype(np.float32)
    if case == "special":
        # as the LU paths pass them: R01 zero before a column, a zero row of
        # L10 with NaN (weight 0, infinite panel entry), an infinite entry in
        # an active row; NaN and inf in A
        R01[..., :C // 3] = 0.0
        L10[..., 3, v // 2] = np.inf
        L10[..., 7, :] = 0.0
        L10[..., 7, v - 1] = np.nan
        A[..., 9, 10] = np.nan
        A[..., 11, 12] = -np.inf
    elif case == "inf_l10_col0":
        # U's row 0 is R01's row 0, exact in 2 bytes: mid = lo = 0 there, so
        # inf * 0 would be NaN where the whole product is infinite
        L10[..., 3, 0] = np.inf
        L10[..., 5, 0] = -np.inf
    elif case == "nonfinite_u":
        R01[..., 2, 7] = np.inf
        R01[..., 4, 11] = np.nan
        R01[..., 0, 13] = -np.inf
    elif case == "overflow":
        # chip_smoke.py's f16 overflow case: one exact product a result,
        # |A - L10 U01| near 100, 300, 25600 or 76800; f16 (max 65504)
        # rounds the last to inf on store
        pick = np.array([1.0, -1.0, 256.0, -256.0], np.float32)
        L10[:] = 0.0
        L10[..., 0] = pick[rng.integers(4, size=(*lead, M))]
        R01 = pick[rng.integers(4, size=(*lead, v, C))] * 100
        R01 = np.where(np.abs(R01) > 200, np.sign(R01) * 300, R01).astype(np.float32)
    return A, L00, R01, L10


def _ulp(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    fi = torch.finfo(dt)
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - 1 - MANTISSA[dt]).clamp_min(fi.tiny * fi.eps)


@pytest.mark.parametrize("case,lead,M,C,v,unit", [
    ("normal", (), 64, 96, 32, True),
    ("normal", (), 100, 300, 8, False),
    ("normal", (), 1, 256, 16, True),
    ("normal", (3,), 64, 96, 32, True),
    ("special", (), 40, 96, 32, True),
    ("special", (3,), 40, 96, 16, False),
    ("inf_l10_col0", (), 40, 96, 32, True),
    ("nonfinite_u", (), 40, 96, 32, False),
    ("overflow", (), 64, 64, 8, True),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_products_follow_the_jax_kernel(dtype, case, lead, M, C, v, unit):
    tdt, jdt = LOW[dtype]
    arrays = _inputs(case, lead, M, C, v, unit, seed=M + C + v + len(lead))
    t_ops = [torch.from_numpy(x).to(tdt) for x in arrays]
    j_ops = [jnp.asarray(x).astype(jdt) for x in arrays]
    out, U01 = split_model(*t_ops, unit=unit)
    jfn = jops.fused_trsm_schur_batched if lead else jops.fused_trsm_schur
    jout, jU = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                for x in jfn(*j_ops, unit=unit))
    assert out.dtype == U01.dtype == tdt
    scale = max(float(t[torch.isfinite(t)].abs().max()) for t in (jout, jU))
    for got, want in ((out.float(), jout), (U01.float(), jU)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        assert torch.equal(got[got.isinf()], want[want.isinf()])
        fin = torch.isfinite(want)
        allowed = _ulp(torch.maximum(got[fin].abs(), want[fin].abs()), tdt) + FUSED_REL_TOL * scale
        assert bool(((got[fin] - want[fin]).abs() <= allowed).all())
    if case == "overflow" and dtype == "float16":
        assert bool(out.isinf().any())
    if case in ("special", "inf_l10_col0"):
        assert bool(out.float().isinf().any())  # the repair keeps the infinite rows infinite
