"""The port's `compressed_psum` against the JAX package's, on four processes.

`tests/multidev/torch_compression_cases.py` runs both at once: the JAX
function under `jax.shard_map` on 4 forced host devices and the port's on 4
gloo CPU ranks, on the same numpy inputs (bits 3, 4, 8 and 16; f32 and
bf16; standard normals, exact .5 levels, zeros; and `compressed_psum_tree`).
Every rank's result equals JAX's bit for bit: the levels are integers summed
exactly in int32, the group's max is exact, and the port forms the scale as
XLA compiles the JAX division by the constant qmax (a product by 1 / qmax
rounded to f32; a true division differs by an ulp of the scale, which moves
a result by an ulp and can move an element at a level's edge by a level).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "multidev" / "torch_compression_cases.py"
SUBPROCESS_TIMEOUT_S = 240

sys.path.insert(0, str(SCRIPT.parent))
try:
    import torch_compression_cases as cases
finally:
    sys.path.remove(str(SCRIPT.parent))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's npz, the port's npz), both subprocesses run at once."""
    out = tmp_path_factory.mktemp("compress")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {mode: subprocess.Popen([sys.executable, str(SCRIPT), mode, str(out / f"{mode}.npz")],
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for mode in ("jax", "torch")}
    logs = {}
    try:
        for mode, p in procs.items():
            logs[mode], _ = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for mode, p in procs.items():
        assert p.returncode == 0, f"{mode} side failed:\n{logs.get(mode, '')[-4000:]}"
    return np.load(out / "jax.npz"), np.load(out / "torch.npz")


@pytest.mark.parametrize("name", [*cases.CASES, "tree"])
def test_compressed_psum_matches_jax_bit_for_bit(results, name):
    want, got = results
    keys = ["tree_a", "tree_b_c"] if name == "tree" else [name]
    for key in keys:
        assert got[key].shape == want[key].shape
        np.testing.assert_array_equal(got[key], want[key])
        assert all(np.array_equal(got[key][r], got[key][0]) for r in range(cases.WORLD))


@pytest.mark.parametrize("name", [n for n, c in cases.CASES.items() if c[2] == "normal"])
def test_compressed_psum_is_the_sum_within_its_levels(results, name):
    """Each element within WORLD half-levels of the exact sum of the inputs
    (each rank's rounding moves it by at most half a level, scale =
    max|x| / qmax), so the quantization is what separates them."""
    bits = cases.CASES[name][0]
    x = cases.inputs(name)
    scale = np.abs(x).max() / (2 ** (bits - 1) - 1)
    err = np.abs(results[1][name][0].astype(np.float64) - x.sum(0, dtype=np.float64))
    slack = 1e-2 * np.abs(x.sum(0)).max() if cases.CASES[name][1] == "bfloat16" else 1e-5
    assert err.max() <= cases.WORLD * scale / 2 + slack


def test_one_process_group_and_bad_bits(tmp_path):
    """A group of one rank returns the quantized input itself; bits outside
    2..16 raise."""
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.training.train_step import _quantize_dequantize

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        x = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 9)).astype(np.float32))
        got = compressed_psum(x, None, 8)
        scale = float(x.abs().max()) * np.float32(1 / 127)
        np.testing.assert_array_equal(
            got.numpy(), (np.round(x.numpy() / np.float32(scale)) * np.float32(scale)))
        torch.testing.assert_close(got, _quantize_dequantize(x, 8), rtol=0, atol=float(scale))
        with pytest.raises(ValueError, match="bits"):
            compressed_psum(x, None, 1)
    finally:
        dist.destroy_process_group()
