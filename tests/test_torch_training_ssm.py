"""The recurrent archs' training cases against the JAX package, on the CPU:
falcon-mamba-7b and jamba-v0.1-52b, split from `tests/test_torch_training.py`
(whose docstring states every tolerance) for run time.  Each case keeps its
test name, parameter id and assertions; the shared bodies are in
`tests/multidev/torch_training_common.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import mamba as jmamba
from repro_torch.models.layers import mamba

sys.path.insert(0, str(Path(__file__).resolve().parent / "multidev"))
try:
    from torch_training_common import (
        GRAD_ABS,
        GRAD_REL,
        LOSS_RTOL,
        S,
        _cfgs,
        _lockstep,
        assert_tree_close,
        crash_resume_case,
        loss_and_grads_case,
        np_batch,
        np_params,
        port_model,
        to_jax,
        to_torch,
        train_step_case,
    )
finally:
    sys.path.remove(str(Path(__file__).resolve().parent / "multidev"))

SSM_ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_loss_and_grads_match_jax(arch):
    loss_and_grads_case(arch)


def test_remat_changes_neither_loss_nor_grads():
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    m = port_model(cfg, np_params(jcfg, 5))
    batch = to_torch(np_batch(cfg, 6))
    named = dict(m.named_parameters())
    out = []
    for remat in (True, False):
        loss = m.loss_fn(batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_mamba_forward_value_and_grad_match_the_jax_layer(arch):
    """With grad on, backend="ref" runs `chunked_scan` and "cuda" the kernel's
    plain version with `MambaScanFn`'s gradient; both against the JAX layer's
    chunked associative scan, in value and in the gradient of every input."""
    jcfg, cfg = _cfgs(arch)
    pos = next(i for i, s in enumerate(cfg.pattern) if s.mixer == "mamba")
    tree = {k: np.asarray(v)[0] for k, v in np_params(jcfg, 7)["blocks"][f"pos{pos}"]
            ["mamba"].items()}
    x = np.random.default_rng(8).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jmamba.mamba_forward(p, jcfg, xx) * w)

    jval, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(to_jax(tree), jnp.asarray(x))
    for backend in ("ref", "cuda"):
        layer = mamba.Mamba(cfg, device="cpu", dtype=torch.float32)
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
        xt = torch.from_numpy(x).requires_grad_()
        val = torch.sum(mamba.mamba_forward(layer, cfg, xt, backend=backend)
                        * torch.from_numpy(w))
        named = dict(layer.named_parameters())
        got = torch.autograd.grad(val, [*named.values(), xt])
        np.testing.assert_allclose(float(val), float(jval), rtol=LOSS_RTOL)
        assert_tree_close({n: g.numpy() for n, g in zip(named, got)}, jgp, GRAD_REL, GRAD_ABS)
        assert_tree_close({"x": got[-1].numpy()}, {"x": jgx}, GRAD_REL, GRAD_ABS)


@pytest.mark.parametrize("accum, compress", [(1, None), (2, None), (1, 8), (2, 8)])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_train_step_matches_jax(arch, accum, compress):
    """As in tests/test_torch_training.py: the port's own three steps
    without compression, lockstep with it."""
    train_step_case(arch, accum, compress)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b"])
def test_train_step_with_bf16_params_matches_jax(arch):
    """As in tests/test_torch_training.py (bf16 parameters in lockstep);
    reduced jamba has no bf16 case (see there)."""
    _lockstep(arch, 1, None, "bfloat16")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_crash_resume_bitwise_identical(tmp_path, arch):
    crash_resume_case(tmp_path, arch)
