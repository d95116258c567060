"""The bf16 / f16 register body of `trsm_right_upper[_batched]`, on the CPU.

The body runs only on the card (`csrc/trsm.cu`,
`trsm_right_upper_reg_kernel`); `chip_smoke.py` holds it to its plain version
there and `tools/trsm_variants.py` to the earlier build's bits.  What the CPU
can hold:

- `right_mode`, the launcher's rule for which body a call takes ("wide": a
  warp loads whole rows in 16-byte runs; "plain": one value a load;
  "smem": v > 32), from shapes, strides, dtype and addresses alone;
- that the operands which the 2-byte paths build take "wide": the
  sequential Cholesky, single and batched, and conflux (windowed) and
  cholesky25d on a 1x1x1 grid, each call captured through a wrapper of the
  "cuda" backend (on CPU tensors its primitives run the plain versions);
- the 2-byte body's index maps, modelled here from the formulas of the
  source: which lane loads which 16-byte run of which row and where its
  widened values land in the swizzled f32 tile Ws, and the same for the
  stores through the tile.  Every value of a warp's rows is read once and
  written once, and each 8-lane phase of a 16-byte shared-memory access
  meets 8 distinct 16-byte bank groups.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels.trsm import right_mode

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "trsm.cu").read_text()
LOW = (torch.bfloat16, torch.float16)


def _zeros(*shape, dtype):
    return torch.zeros(*shape, dtype=dtype)


# (B, expected mode): every B has unit column stride; U is [.., v, v].
def _case(name: str, dtype):
    R, v = 40, 32
    if name == "contiguous":
        return _zeros(R, v, dtype=dtype), "wide"
    if name == "v24":
        return _zeros(R, 24, dtype=dtype), "wide"
    if name == "v31":
        return _zeros(R, 31, dtype=dtype), "plain"
    if name == "v1":
        return _zeros(R, 1, dtype=dtype), "plain"
    if name == "window":
        return _zeros(R, 3 * v, dtype=dtype)[:, v:2 * v], "wide"
    if name == "window_off1":
        return _zeros(R, 3 * v, dtype=dtype)[:, v + 1:2 * v + 1], "plain"
    if name == "batched":
        return _zeros(3, R, v, dtype=dtype), "wide"
    if name == "batched_odd_batch_stride":
        # bsb = R v + 4: a whole 16-byte run of f32 values, not of 2-byte ones.
        B = _zeros(3 * (R * v + 4), dtype=dtype).as_strided((3, R, v), (R * v + 4, v, 1))
        return B, "plain" if dtype.itemsize == 2 else "wide"
    if name == "v33":
        return _zeros(R, 33, dtype=dtype), "smem"
    if name == "v28":
        # 28 values: 7 runs of f32, 14 of f64, 3.5 of 2-byte values.
        return _zeros(R, 28, dtype=dtype), "plain" if dtype.itemsize == 2 else "wide"
    if name == "v30":
        # 30 values: whole runs of f64 only.
        return _zeros(R, 30, dtype=dtype), "wide" if dtype.itemsize == 8 else "plain"
    raise ValueError(name)


CASES = ("contiguous", "v24", "v31", "v1", "window", "window_off1", "batched",
         "batched_odd_batch_stride", "v33", "v28", "v30")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [*LOW, torch.float32, torch.float64])
def test_right_mode_follows_the_launchers_rule(dtype, name):
    """`right_mode` on CPU tensors: the rule alone.  A 16-byte run is 8
    values in bf16 / f16, 4 in f32 and 2 in f64; the base, row stride, batch
    stride and v must be whole runs for "wide", and v > 32 is "smem"."""
    B, want = _case(name, dtype)
    v = B.shape[-1]
    U = torch.eye(v, dtype=dtype).expand(*B.shape[:-2], v, v)
    assert right_mode(B, U) == want
    if B.ndim == 3:
        assert right_mode(B[0], U[0]) == ("smem" if v > 32 else
                                          "wide" if v % (16 // dtype.itemsize) == 0 else "plain")


class _RightModes(tbackend.CudaBackend):
    """The "cuda" backend, keeping the body each right-solve call would take."""

    name = "cuda_right_modes"

    def __init__(self):
        self.modes = []

    def trsm_right_upper(self, B, U):
        self.modes.append(right_mode(B, U))
        return super().trsm_right_upper(B, U)

    def trsm_right_upper_batched(self, B, U):
        self.modes.append(right_mode(B, U))
        return super().trsm_right_upper_batched(B, U)


def _spd(rng, shape) -> np.ndarray:
    n = shape[-1]
    G = rng.standard_normal(shape).astype(np.float32)
    return G @ np.swapaxes(G, -1, -2) / n + np.eye(n, dtype=np.float32)


PATHS = {
    "sequential_chol": lambda N: (N, dict(strategy="sequential_chol"), (N, N)),
    "sequential_chol_batched": lambda N: ((4, N), dict(strategy="sequential_chol"), (4, N, N)),
    "conflux_windowed": lambda N: (N, dict(strategy="conflux", grid=GridConfig(1, 1, 1, 32, N),
                                           hotloop="windowed"), (N, N)),
    "cholesky25d": lambda N: (N, dict(strategy="cholesky25d", grid=GridConfig(1, 1, 1, 32, N)),
                              (N, N)),
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_the_2byte_paths_pass_operands_that_take_the_wide_body(dtype, path):
    """Every right solve of a 2-byte path at v = 32 takes "wide": its B is a
    new contiguous panel ([R, 32] or [Bb, R, 32])."""
    N = 128
    shape, kw, a_shape = PATHS[path](N)
    rec = _RightModes()
    tbackend.register_backend(rec.name, rec, overwrite=True)
    rng = np.random.default_rng(0)
    A = _spd(rng, a_shape) if "chol" in path else rng.standard_normal(a_shape).astype(np.float32)
    cfg = SolverConfig(v=32, backend=rec.name, compute_dtype=dtype, **kw)
    clear_plan_cache()
    plan(shape, cfg, device="cpu").execute(torch.from_numpy(A))
    assert rec.modes == ["wide"] * (N // 32)


# The 2-byte body's index maps, as the source writes them.
K_REG_V, K_RUN, K_RUN2 = 32, 4, 8  # values a row; f32 values a 16-byte run; 2-byte ones
FORMULAS = (
    "return r * kRegV + ((m / kRun) ^ (r & 7)) * kRun + m % kRun;",  # at(r, m)
    "return (c ^ (r >> 1 & 3)) + 4 * (r & 1);",  # slot2(c, r)
    "const int r = lane / kRowRuns2 + i * kRowsAtOnce2;",
    "const int m = lane % kRowRuns2 * kRun2;",
    "*reinterpret_cast<Run<T>*>(ws + at(r, m + h * kRun)) = run;",
    "*reinterpret_cast<uint4*>(ws + lane * kRegV + slot2(c, lane) * kRun) = run;",
    "*reinterpret_cast<const uint4*>(ws + r * kRegV + slot2(c, r) * kRun);",
)


def at(r: int, m: int) -> int:
    """Ws index (f32 values) of value m of row r."""
    return r * K_REG_V + ((m // K_RUN) ^ (r & 7)) * K_RUN + m % K_RUN


def slot2(c: int, r: int) -> int:
    """16-byte slot of row r's Ws row where the stores put 2-byte run c."""
    return (c ^ (r >> 1 & 3)) + 4 * (r & 1)


def bank_group(byte: int) -> int:
    return byte // 16 % 8


def test_the_model_reads_the_sources_formulas():
    for formula in FORMULAS:
        assert formula in SOURCE, formula


@pytest.mark.parametrize("v", [8, 16, 24, 32])
def test_2byte_wide_loads_read_each_value_once_without_bank_conflicts(v):
    """Load instruction i: lane l takes run l % 4 of row l / 4 + 8 i (8 whole
    rows an instruction); the run's 8 values widen into f32 runs at
    at(r, 8c) and at(r, 8c + 4).  Then each lane reads its own row back."""
    read, tile = {}, {}
    for i in range(4):
        rows = set()
        for half in range(2):
            for phase in range(4):
                groups = []
                for lane in range(8 * phase, 8 * phase + 8):
                    r, c = lane // 4 + 8 * i, lane % 4
                    m0 = c * K_RUN2 + half * K_RUN
                    groups.append(bank_group(4 * at(r, m0)))
                    for e in range(K_RUN):
                        value = (r, m0 + e) if c * K_RUN2 < v else None  # past v: zeros
                        assert at(r, m0 + e) not in tile
                        tile[at(r, m0 + e)] = value
                        if value is not None:
                            assert value not in read
                            read[value] = at(r, m0 + e)
                    rows.add(r)
                assert len(set(groups)) == 8
        assert rows == set(range(8 * i, 8 * i + 8))
    assert set(read) == {(r, m) for r in range(32) for m in range(v)}
    assert len(tile) == 32 * K_REG_V
    for c in range(K_REG_V // K_RUN):  # read-back: lane l, run c of row l
        for phase in range(4):
            lanes = range(8 * phase, 8 * phase + 8)
            assert len({bank_group(4 * at(lane, c * K_RUN)) for lane in lanes}) == 8
    for lane in range(32):  # each thread's row, in order, holds what B held
        assert [tile[at(lane, m)] for m in range(v)] == [(lane, m) for m in range(v)]


@pytest.mark.parametrize("v", [8, 16, 24, 32])
def test_2byte_wide_stores_write_each_value_once_without_bank_conflicts(v):
    """Each lane writes run c of its own row (values 8c..8c+7, narrowed) to
    slot2(c, lane) of its own 128-byte row of Ws, then store instruction i:
    lane l takes run l % 4 of row l / 4 + 8 i from slot2 and writes it to X."""
    runs = v // K_RUN2
    tile = {}
    for c in range(4):  # the lanes' writes: one instruction a run
        for phase in range(4):
            groups = []
            for lane in range(8 * phase, 8 * phase + 8):
                byte = lane * 4 * K_REG_V + 16 * slot2(c, lane)
                assert lane * 128 <= byte < (lane + 1) * 128  # its own row, where it read
                assert byte not in tile
                tile[byte] = (lane, c)
                groups.append(bank_group(byte))
            assert len(set(groups)) == 8
    written = []
    for i in range(4):
        rows = set()
        for phase in range(4):
            groups = []
            for lane in range(8 * phase, 8 * phase + 8):
                r, c = lane // 4 + 8 * i, lane % 4
                byte = r * 4 * K_REG_V + 16 * slot2(c, r)
                groups.append(bank_group(byte))
                assert tile[byte] == (r, c)
                if c < runs:
                    written.append((r, c))
                    rows.add(r)
            assert len(set(groups)) == 8
        assert rows == set(range(8 * i, 8 * i + 8))
    assert sorted(written) == [(r, c) for r in range(32) for c in range(runs)]
