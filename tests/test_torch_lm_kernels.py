"""The LM kernels' plain versions (what the wrappers run for CPU tensors)
against the JAX package's Pallas kernels in interpret mode and their jnp
references.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances: 2e-4 (rtol and atol) in f32, where the two sides sum the same
terms in other orders (f32 eps is 6e-8; the softmax and the PV sum add a few
hundred terms at most here); 2e-2 in bf16, the tolerance of
`tests/test_kernels.py::_tol`: bf16 keeps 8 bits (0.4% per rounding), the
Pallas kernel keeps its scores in f32 where the references round them to
bf16, and the output is rounded to bf16 once more.  The Pallas kernel asserts
S % 64 == 0, so ragged S is held against the jnp reference only.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, dtype=jdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 128, 4, 4, 32),   # gq = 1
                                         (1, 128, 4, 2, 16),   # gq = 2
                                         (2, 64, 8, 2, 32)])   # gq = 4
def test_flash_causal_matches_pallas_and_ref(B, S, H, KV, hd, dtype):
    (q, k, v), (jq, jk, jv) = _both(_qkv(B, S, H, KV, hd, seed=S + H + hd), dtype)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(jops.flash_attention(jq, jk, jv, bq=64, bkv=64)),
                               **tol)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk, jv)), **tol)


@pytest.mark.parametrize("case", ["window", "softcap", "window_softcap", "bidirectional"])
def test_flash_masks_and_softcap_match_pallas(case):
    kw = {"window": dict(window=48), "softcap": dict(softcap=30.0),
          "window_softcap": dict(window=32, softcap=5.0),
          "bidirectional": dict(causal=False)}[case]
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 128, 4, 2, 16, seed=11), "float32")
    out = ops.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(out), _np(jops.flash_attention(jq, jk, jv, bq=64, bkv=64, **kw)),
                               **F32_TOL)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk, jv, **kw)), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kw", [(100, {}), (77, dict(window=20)), (130, dict(causal=False)),
                                  (45, dict(softcap=10.0, window=7))])
def test_flash_ragged_length_matches_ref(S, kw, dtype):
    """S not a multiple of 64: the Pallas kernel refuses it, the CUDA kernel
    masks its ragged tiles; the plain version is dense and takes any S."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, S, 4, 2, 32, seed=S), dtype)
    out = ops.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk, jv, **kw)),
                               **DTYPES[dtype][2])


def test_flash_cpu_tensors_run_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 2, 1, 16, seed=0))
    before = fa_mod.flash_attention.launches
    out = fa_mod.flash_attention(q, k, v, window=8)
    assert fa_mod.flash_attention.launches == before
    assert torch.equal(out, ref.flash_attention(q, k, v, window=8))


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 4, 20), (1, 8, 2, 20)), "hd in 16"),
    (((1, 8, 3, 16), (1, 8, 2, 16)), "H % KV"),
    (((1, 8, 4, 16), (1, 9, 2, 16)), "same B, S"),
    (((1, 8, 4, 16), (1, 8, 2)), "need q"),
])
def test_flash_wrapper_refuses_shapes_the_kernel_cannot_take(shapes, match):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        fa_mod._check(q, k, k, None, None)


def test_flash_wrapper_refuses_cpu_tensors_at_the_launch_check():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod._check(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(), None, None)
    with pytest.raises(ValueError, match="window"):
        fa_mod._check(q, q, q, 0, None)


# --------------------------------------------------------------------------
# mamba_scan
# --------------------------------------------------------------------------

def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 0.999, (B, S, di, N)).astype(np.float32)
    b = rng.standard_normal((B, S, di, N)).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    return a, b, C


@pytest.mark.parametrize("B,S,di,N", [(2, 64, 32, 4), (1, 128, 64, 16), (2, 32, 16, 8)])
def test_mamba_scan_matches_pallas_and_ref(B, S, di, N):
    a, b, C = _scan_inputs(B, S, di, N, seed=B * S + N)
    y = ops.mamba_scan(*(torch.from_numpy(x) for x in (a, b, C)))
    assert y.dtype == torch.float32 and y.shape == (B, S, di)
    ja, jb, jC = (jnp.asarray(x) for x in (a, b, C))
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.mamba_scan(ja, jb, jC, bd=16, cs=32)),
                               **F32_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.mamba_scan(ja, jb, jC)), **F32_TOL)


@pytest.mark.parametrize("S", [1, 7, 50])
def test_mamba_scan_final_state_is_the_last_recurrence_step(S):
    """h_S from `return_state` equals the recurrence run in float64 numpy to
    within f32 rounding, and y is unchanged by asking for it."""
    a, b, C = _scan_inputs(2, S, 8, 4, seed=S)
    y, h = ops.mamba_scan(*(torch.from_numpy(x) for x in (a, b, C)), return_state=True)
    assert h.shape == (2, 8, 4) and h.dtype == torch.float32
    h64 = np.zeros((2, 8, 4))
    for t in range(S):
        h64 = a[:, t].astype(np.float64) * h64 + b[:, t]
    np.testing.assert_allclose(h.numpy(), h64, **F32_TOL)
    assert torch.equal(y, ops.mamba_scan(*(torch.from_numpy(x) for x in (a, b, C))))


def test_mamba_cpu_tensors_run_the_plain_version_and_count_no_launch():
    a, b, C = (torch.from_numpy(x) for x in _scan_inputs(1, 16, 8, 4, seed=0))
    before = ms_mod.mamba_scan.launches
    y, h = ms_mod.mamba_scan(a, b, C, return_state=True)
    assert ms_mod.mamba_scan.launches == before
    y_ref, h_ref = ref.mamba_scan(a, b, C, return_state=True)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 4, 3), (1, 8, 3)), "N in"),
    (((1, 8, 4, 4), (1, 8, 5)), "need a, b"),
    (((1, 8, 4), (1, 8, 4)), "need a, b"),
])
def test_mamba_wrapper_refuses_shapes_the_kernel_cannot_take(shapes, match):
    a = torch.zeros(shapes[0])
    with pytest.raises(ValueError, match=match):
        ms_mod._check(a, a, torch.zeros(shapes[1]))
