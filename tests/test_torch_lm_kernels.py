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

NEG_INF = -1e30  # the kernels' finite mask value
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


def _kernel_schedule_bf16(q, k, v, *, causal=True, window=None, softcap=None):
    """The bf16 CUDA kernel's block schedule, emulated with torch on the CPU.

    Blocks of 128 packed rows (r = s * gq + g), as two warpgroups of 64;
    kv tiles of 128 keys for hd <= 128, else 64; each block walks its skip
    range [j_first, kv_end) and masks a tile only where the block's test
    says the tile needs it.  q, k and v are padded with zeros to
    ceil(hd / 64) * 64 columns and k, v to whole kv tiles past S, as the
    kernel's Q staging and TMA boxes pad them.  Scores, m, l and acc are f32,
    p is rounded to bf16 before the PV product and l sums the unrounded p.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    gq = H // KV
    hdp = -(-hd // 64) * 64
    keys = 128 if hdp <= 128 else 64
    rows_total = S * gq
    n_qt = -(-rows_total // 128)
    s_pad = -(-S // keys) * keys + keys
    qf = torch.nn.functional.pad(q.float(), (0, hdp - hd))
    kf = torch.nn.functional.pad(k.float(), (0, hdp - hd, 0, 0, 0, s_pad - S))
    vf = torch.nn.functional.pad(v.float(), (0, hdp - hd, 0, 0, 0, s_pad - S))
    scale = torch.tensor(hd**-0.5, dtype=torch.float32)
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        for kvh in range(KV):
            packed = qf[b, :, kvh * gq:(kvh + 1) * gq].reshape(rows_total, hdp)
            packed = torch.nn.functional.pad(packed, (0, 0, 0, n_qt * 128 - rows_total))
            res = torch.zeros(n_qt * 128, hdp)
            for qt in reversed(range(n_qt)):
                r0 = qt * 128
                q_lo = r0 // gq
                q_hi = (min(r0 + 128, rows_total) - 1) // gq
                kv_end = min(S, q_hi + 1) if causal else S
                kv_begin = max(0, q_lo - window + 1) if window else 0
                j_first = kv_begin // keys * keys
                n_tiles = -(-(kv_end - j_first) // keys)
                for w0 in (r0, r0 + 64):
                    qw = packed[w0:w0 + 64]
                    pos = (torch.arange(w0, w0 + 64) // gq)[:, None]
                    m = torch.full((64, 1), NEG_INF)
                    l = torch.zeros(64, 1)
                    acc = torch.zeros(64, hdp)
                    for t in range(n_tiles):
                        j0 = j_first + t * keys
                        s = (qw @ kf[b, j0:j0 + keys, kvh].T) * scale
                        if softcap is not None:
                            s = softcap * torch.tanh(s / softcap)
                        if ((causal and j0 + keys - 1 > q_lo)
                                or (window and j0 <= q_hi - window) or j0 + keys > S):
                            j = torch.arange(j0, j0 + keys)[None, :]
                            ok = torch.ones(64, keys, dtype=torch.bool)
                            if causal:
                                ok &= j <= pos
                            if window:
                                ok &= j > pos - window
                            s = torch.where(ok, s, torch.tensor(NEG_INF))
                            s = torch.where(j >= S, torch.tensor(-float("inf")), s)
                        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new)
                        l = l * alpha + p.sum(-1, keepdim=True)
                        acc = acc * alpha + p.bfloat16().float() @ vf[b, j0:j0 + keys, kvh]
                        m = m_new
                    res[w0:w0 + 64] = acc / torch.clamp(l, min=1e-30)
            out[b, :, kvh * gq:(kvh + 1) * gq] = res[:rows_total, :hd].reshape(S, gq, hd)
    return out.to(q.dtype)


@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("gq,hd,S", [(1, 64, 1000), (2, 80, 300), (4, 128, 300),
                                     (5, 256, 300), (12, 96, 77)])
def test_flash_bf16_kernel_schedule_matches_ref(gq, hd, S, mask, softcap):
    """The bf16 kernel's tile schedule (skip range, packing, per-block mask
    test, hd padding, p rounded before PV) against the dense
    references: a wrong skip range or packing is off by O(1).  gq = 5 with
    64-key tiles puts q tiles across kv tile boundaries."""
    kw = {"causal": dict(), "window": dict(window=100),
          "bidirectional": dict(causal=False)}[mask]
    KV = 2 if gq < 12 else 1
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, S, gq * KV, KV, hd, seed=gq * hd + S), "bfloat16")
    out = _kernel_schedule_bf16(q, k, v, softcap=softcap, **kw)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk, jv, softcap=softcap,
                                                                  **kw)), **BF16_TOL)
    np.testing.assert_allclose(_np(out), _np(ref.flash_attention(q, k, v, softcap=softcap, **kw)),
                               **BF16_TOL)


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
