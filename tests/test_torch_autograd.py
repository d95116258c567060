"""The autograd Functions of `repro_torch.kernels.autograd`: their backward is
the gradient of their forward (`torch.autograd.gradcheck` in f64 on the
CPU).  Split from `tests/test_torch_training.py` for run time; each case
keeps its test name, parameters and assertions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.mark.parametrize("H, KV, causal, window, softcap, chunk", [
    (2, 2, True, None, None, 8),     # causal
    (2, 1, True, 3, None, 4),        # windowed, GQA 2:1
    (4, 2, False, None, 5.0, 3),     # bidirectional, softcapped, short last chunk
    (3, 1, True, 4, 2.0, 8),         # all of them, GQA 3:1
])
def test_flash_attention_fn_gradcheck(H, KV, causal, window, softcap, chunk):
    """In f64 on the CPU the forward is the kernel's plain version (dense
    softmax) and the backward `blocked_attention`'s gradient: gradcheck holds
    the one against finite differences of the other."""
    from repro_torch.kernels.autograd import FlashAttentionFn

    rng = np.random.default_rng(H * 10 + KV)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((2, 7, H, 4), (2, 7, KV, 4), (2, 7, KV, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal, window, softcap, chunk),
        (q, k, v))


@pytest.mark.parametrize("S_, chunk, outputs", [(8, 4, "both"), (12, 4, "y"), (6, 2, "h"),
                                                (4, 4, "both")])
def test_mamba_scan_fn_gradcheck(S_, chunk, outputs):
    """Forward: the sequential scan (the kernel's plain version); backward: the
    chunked scan's gradient, chunk by chunk, through y, h_S or both."""
    from repro_torch.kernels.autograd import MambaScanFn

    rng = np.random.default_rng(S_ + chunk)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S_, 3, 2))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, S_, 3, 2))).requires_grad_()
    C = torch.from_numpy(rng.standard_normal((2, S_, 2))).requires_grad_()

    def f(a, b, C):
        y, h = MambaScanFn.apply(a, b, C, chunk)
        return {"both": (y, h), "y": y, "h": h}[outputs]

    assert torch.autograd.gradcheck(f, (a, b, C))
