"""bf16 score buffers (`attn_score_dtype="bfloat16"`) in the port against
the JAX package, on the CPU.

The JAX `blocked_attention(score_dtype=bf16)` holds each chunk's scaled,
softcapped and masked score, s - m_new and p in bf16 (its Python-float
scale, cap and mask value meet the bf16 array as bf16 constants, and its
chunk sum of p is a bf16 sum); m, l and acc stay f32.  Op by op, the port's
`blocked_attention` computes the same function:

- against JAX evaluated op by op (`jax.disable_jit()`, each op rounding to
  bf16 as written): bit for bit on bf16 inputs, within 1e-6 (rtol and atol)
  on f32 inputs (their f32 products sum in other orders; 1.2e-7 read);
- against JAX compiled (its scan body is an XLA computation, and XLA's
  default `xla_allow_excess_precision` drops some of the bf16 roundings):
  within 2e-2 (rtol and atol), the flash kernel's bf16 tolerance (1.6e-2
  read);
- `ref.flash_attention(score_dtype=bf16)`, the kernel's plain version
  (dense: s - m against the row's max, not a running max), within the same
  2e-2 of `blocked_attention(score_dtype=bf16)` (1.6e-2 read);
- reduced qwen3-8b with bf16 scores, `loss_fn` and its gradient through
  both backends against JAX's compiled `value_and_grad`: loss within 5e-4
  relative (7.3e-5 read), each gradient leaf within 5e-2 of its max (1.1%
  read: JAX's autodiff of its bf16 ops and PyTorch's round the backward at
  other points; JAX's own bf16-score gradient is 0.8% from its f32-score
  one).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import blocked_attention as j_blocked
from repro.models.model_zoo import build_model as jbuild
from repro_torch.interop import lm_params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models.layers.attention import blocked_attention

sys.path.insert(0, str(Path(__file__).resolve().parent / "multidev"))
try:
    from torch_training_common import (
        _cfgs,
        assert_tree_close,
        flat,
        np_batch,
        np_params,
        port_grads,
        port_model,
        to_jax,
    )
finally:
    sys.path.remove(str(Path(__file__).resolve().parent / "multidev"))

EAGER_F32_TOL = 1e-6
COMPILED_TOL = 2e-2  # rtol and atol
LOSS_RTOL, GRAD_REL = 5e-4, 5e-2
BF16 = torch.bfloat16

# (B, S, H, KV, hd, causal, window, softcap, chunk)
CASES = [
    (2, 16, 4, 2, 32, True, None, None, 8),
    (2, 16, 4, 2, 32, True, 5, None, 4),
    (2, 16, 4, 2, 32, False, None, 30.0, 8),
    (1, 24, 6, 2, 16, True, 7, 20.0, 8),
    (2, 12, 2, 1, 16, False, None, None, 4),
]
IDS = ["causal", "window", "softcap", "window_softcap_gq3", "bidirectional"]


def _qkv(case, seed: int):
    B, S, H, KV, hd = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _jax(q, k, v, dtype, case):
    S = q.shape[1]
    causal, window, softcap, chunk = case[5:]
    pos = jnp.arange(S)
    out = j_blocked(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)), pos, pos,
                    causal=causal, window=window, softcap=softcap, chunk=chunk,
                    score_dtype=jnp.bfloat16)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype, case, fn=blocked_attention):
    S = q.shape[1]
    causal, window, softcap, chunk = case[5:]
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    if fn is blocked_attention:
        out = fn(*t, torch.arange(S), torch.arange(S), causal=causal, window=window,
                 softcap=softcap, chunk=chunk, score_dtype=BF16)
    else:
        out = fn(*t, causal=causal, window=window, softcap=softcap, score_dtype=BF16)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_attention_bf16_scores_match_jax_op_by_op(case, dtype):
    q, k, v = _qkv(case, 1)
    with jax.disable_jit():
        want = _jax(q, k, v, jnp.dtype(dtype), case)
    got = _port(q, k, v, getattr(torch, dtype), case)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=EAGER_F32_TOL, atol=EAGER_F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_attention_bf16_scores_match_compiled_jax(case, dtype):
    q, k, v = _qkv(case, 2)
    want = _jax(q, k, v, jnp.dtype(dtype), case)
    got = _port(q, k, v, getattr(torch, dtype), case)
    np.testing.assert_allclose(got, want, rtol=COMPILED_TOL, atol=COMPILED_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_flash_bf16_scores_match_blocked_attention(case, dtype):
    """The kernel's plain version (and the wrapper on CPU tensors, which runs
    it) against `blocked_attention(score_dtype=bf16)`."""
    q, k, v = _qkv(case, 3)
    want = _port(q, k, v, getattr(torch, dtype), case)
    for fn in (ref.flash_attention, ops.flash_attention):
        got = _port(q, k, v, getattr(torch, dtype), case, fn=fn)
        np.testing.assert_allclose(got, want, rtol=COMPILED_TOL, atol=COMPILED_TOL)


def test_bf16_scores_round_where_f32_scores_do_not():
    """The bf16 path differs from the f32 one (the flag reaches the
    function) and an unknown score dtype is refused."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(CASES[0], 4))
    pos = torch.arange(q.shape[1])
    f32 = blocked_attention(q, k, v, pos, pos, chunk=8)
    low = blocked_attention(q, k, v, pos, pos, chunk=8, score_dtype=BF16)
    assert not torch.equal(f32, low)
    assert torch.equal(ref.flash_attention(q, k, v), ops.flash_attention(q, k, v))
    with pytest.raises(TypeError, match="score_dtype"):
        ops.flash_attention(q, k, v, score_dtype=torch.float16)


@functools.lru_cache(None)
def _qwen3_bf16_scores():
    """(cfg, parameters, batch, JAX's compiled loss and gradient)."""
    jcfg, cfg = (dataclasses.replace(c, attn_score_dtype="bfloat16") for c in _cfgs("qwen3-8b"))
    P = np_params(jcfg, 0)
    batch = np_batch(cfg, 1)
    jm = jbuild(jcfg)
    return cfg, P, batch, jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b, remat=True)))(
        to_jax(P), to_jax(batch))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_loss_and_grads_with_bf16_scores_match_jax(backend):
    """Reduced qwen3-8b with attn_score_dtype="bfloat16": "cuda" runs the
    kernel's plain version forward and `blocked_attention(score_dtype=bf16)`'s
    gradient (FlashAttentionFn), "ref" the blocked path both ways."""
    cfg, P, batch, (jl, jg) = _qwen3_bf16_scores()
    m = port_model(cfg, P)
    m.backend = backend
    loss, grads = port_grads(m, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert_tree_close(flat(lm_params_to_numpy(cfg, grads)), flat(jg), GRAD_REL)
