"""The port's MoE layer (`repro_torch.models.layers.moe`) against the JAX
package's (`repro.models.layers.moe`), on the CPU, in f32.

Parameters and inputs are drawn with numpy from a seed and handed to both.
The routing is held exactly: `_route`'s expert choices (ties included,
where `jax.lax.top_k` ranks the lower expert first) and `_dispatch_sort`'s
four index arrays.  The outputs are held to 2e-4 (rtol and atol), the LM
tests' f32 tolerance: both sides sum the same products in other orders
(f32 eps is 6e-8 and the outputs are O(1)).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.layers import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import LayerSpec, ModelConfig, MoEConfig, build_model
from repro_torch.models.layers import moe

TOL = dict(rtol=2e-4, atol=2e-4)
D = 32


def _cfgs(E=8, K=2, G=2, cap_factor=8.0, dispatch="sort", norm_topk=True, act="silu"):
    """The same MoE layer config in both packages."""
    common = dict(name="t", family="moe", n_layers=2, d_model=D, n_heads=4, n_kv=2,
                  head_dim=8, d_ff=64, vocab=97, param_dtype="float32", act=act)
    mo = dict(n_experts=E, top_k=K, d_ff_expert=16, n_dispatch_groups=G,
              capacity_factor=cap_factor, dispatch=dispatch, router_norm_topk=norm_topk)
    return (JModelConfig(pattern=(JLayerSpec("attn", "moe"),), moe=JMoEConfig(**mo), **common),
            ModelConfig(pattern=(LayerSpec("attn", "moe"),), moe=MoEConfig(**mo), **common))


def _params(cfg, seed: int, router_scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    E, ff = cfg.moe.n_experts, cfg.moe.d_ff_expert
    return {"router": (rng.standard_normal((D, E)) * router_scale).astype(np.float32),
            "w_in": (rng.standard_normal((E, D, 2, ff)) * D**-0.5).astype(np.float32),
            "w_out": (rng.standard_normal((E, ff, D)) * ff**-0.5).astype(np.float32)}


def _port(cfg, P: dict) -> moe.MoE:
    layer = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in P.items()})
    return layer.requires_grad_(False)


def _x(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# Routing and dispatch indices: exact.
# --------------------------------------------------------------------------

def _top_e(kind: str, G: int, T: int, K: int, E: int) -> np.ndarray:
    rng = np.random.default_rng([G, T, K, E])
    if kind == "one_expert":  # heavy oversubscription: every choice wants expert 0
        return np.zeros((G, T, K), np.int32)
    if kind == "skewed":  # most choices on two experts, distinct within a token
        w = np.r_[[8.0, 4.0], np.ones(E - 2)]
        return np.stack([np.stack([rng.choice(E, K, replace=False, p=w / w.sum())
                                   for _ in range(T)]) for _ in range(G)]).astype(np.int32)
    return np.stack([np.stack([rng.permutation(E)[:K] for _ in range(T)])
                     for _ in range(G)]).astype(np.int32)


@pytest.mark.parametrize("kind,G,T,K,E,cap", [
    ("uniform", 1, 16, 2, 4, 16), ("uniform", 2, 16, 2, 8, 3), ("uniform", 3, 7, 1, 4, 1),
    ("uniform", 2, 32, 8, 16, 20), ("skewed", 2, 24, 2, 8, 4), ("skewed", 1, 40, 4, 8, 10),
    ("one_expert", 1, 64, 4, 2, 8), ("one_expert", 2, 9, 1, 3, 1),
])
def test_dispatch_sort_matches_jax_exactly(kind, G, T, K, E, cap):
    top_e = _top_e(kind, G, T, K, E)
    got = moe._dispatch_sort(torch.from_numpy(top_e).long(), T, E, cap)
    want = jmoe._dispatch_sort(jnp.asarray(top_e), T, E, cap)
    for name, g, w in zip(("token_for_slot", "valid", "slot", "keep"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if kind == "one_expert":  # only cap choices of a group kept
        assert int(got[3].sum()) == G * cap
        assert int(got[1][:, 0].sum()) == G * cap and not bool(got[1][:, 1:].any())


@pytest.mark.parametrize("case", ["gauss", "zero_router", "integer_ties"])
@pytest.mark.parametrize("K,norm_topk", [(1, True), (2, True), (2, False), (8, True)])
def test_route_matches_jax_exactly_on_ties(case, K, norm_topk):
    """top_e equal to JAX's; top_p within 2e-4.  A zero router makes every
    probability tie; integer inputs and router weights make exact integer
    logits with many ties between some experts."""
    jcfg, cfg = _cfgs(E=16, K=K, norm_topk=norm_topk)
    P = _params(cfg, 1)
    x = _x((2, 12, D), 2)
    if case == "zero_router":
        P["router"][:] = 0.0
    elif case == "integer_ties":
        rng = np.random.default_rng(3)
        P["router"] = rng.integers(-1, 2, P["router"].shape).astype(np.float32)
        x = rng.integers(-2, 3, x.shape).astype(np.float32)
    top_p, top_e = moe._route(_port(cfg, P), cfg, torch.from_numpy(x))
    jp, je = jmoe._route({k: jnp.asarray(v) for k, v in P.items()}, jcfg, x)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp), **TOL)
    assert top_p.dtype == torch.float32
    if case == "zero_router":
        assert (top_e.numpy() == np.arange(K)).all()


@pytest.mark.parametrize("shape,groups", [((2, 16), 2), ((3, 5), 4), ((2, 6), 8), ((1, 1), 16)])
def test_dispatch_shape_follows_the_jax_group_split(shape, groups):
    """G halves from min(groups, B*S) until it divides B*S (15 tokens, 4
    groups: 1 group; 12 tokens, 8 groups: 4)."""
    _, cfg = _cfgs(G=groups)
    B, S = shape
    G, T, cap = moe.dispatch_shape(cfg, B, S)
    want_G = min(groups, B * S)
    while (B * S) % want_G:
        want_G //= 2
    assert (G, T) == (want_G, B * S // want_G)
    assert cap == max(int(T * cfg.moe.top_k / cfg.moe.n_experts * 8.0), 1)


# --------------------------------------------------------------------------
# moe_forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
@pytest.mark.parametrize("cap_factor", [1.0, 8.0])
@pytest.mark.parametrize("K,act", [(1, "silu"), (2, "silu"), (4, "gelu")])
def test_moe_forward_matches_jax(dispatch, cap_factor, K, act):
    jcfg, cfg = _cfgs(K=K, cap_factor=cap_factor, dispatch=dispatch, act=act)
    P = _params(cfg, 4)
    x = _x((2, 16, D), 5)
    got = moe.moe_forward(_port(cfg, P), cfg, torch.from_numpy(x))
    want = jmoe.moe_forward({k: jnp.asarray(v) for k, v in P.items()}, jcfg, x)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cap_factor == 1.0:  # this case really drops choices
        G, T, cap = moe.dispatch_shape(cfg, 2, 16)
        _, top_e = moe._route(_port(cfg, P), cfg, torch.from_numpy(x).reshape(G, T, D))
        assert not bool(moe._dispatch_sort(top_e, T, 8, cap)[3].all())


@pytest.mark.parametrize("K", [1, 2, 4])
def test_sort_equals_scatter_when_nothing_drops(K):
    _, cfg = _cfgs(K=K, cap_factor=8.0)
    layer = _port(cfg, _params(cfg, 6))
    x = torch.from_numpy(_x((2, 16, D), 7))
    y_sort = moe.moe_forward(layer, cfg, x)
    y_scat = moe.moe_forward(layer, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="scatter")), x)
    np.testing.assert_allclose(y_sort.numpy(), y_scat.numpy(), atol=1e-6)


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
@pytest.mark.parametrize("B", [1, 2, 5])
def test_decode_shaped_input_matches_jax(dispatch, B):
    """[B, 1, d], as a decode step passes it: one token per group where B
    allows, cap 1."""
    jcfg, cfg = _cfgs(K=2, cap_factor=1.25, dispatch=dispatch)
    P = _params(cfg, 8)
    x = _x((B, 1, D), 9)
    got = moe.moe_forward(_port(cfg, P), cfg, torch.from_numpy(x))
    want = jmoe.moe_forward({k: jnp.asarray(v) for k, v in P.items()}, jcfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_dispatch_raises():
    _, cfg = _cfgs(dispatch="dense")
    with pytest.raises(ValueError, match="unknown MoE dispatch 'dense'"):
        moe.moe_forward(_port(cfg, _params(cfg, 0)), cfg, torch.zeros(1, 4, D))


# --------------------------------------------------------------------------
# The router stays f32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_router_stays_f32_in_a_bf16_model(arch):
    """build_model(dtype=bf16) keeps each router in f32 and every other
    MoE leaf in bf16; lm_params_from_numpy(dtype=bf16) leaves the router
    unrounded, and the bf16 model loads it and serves a forward."""
    cfg = reduced(get_config(arch), groups=1)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    state = model.state_dict()
    routers = [k for k in state if k.endswith(".moe.router")]
    assert routers
    for name, t in state.items():
        if ".moe." in name or name == "embed":
            assert t.dtype == (torch.float32 if name in routers else torch.bfloat16), name
    tree = {k: v.float().numpy() for k, v in state.items()}
    P = {"embed": tree["embed"], "final_norm": {"scale": tree["final_norm.scale"]},
         "blocks": {}}
    if "head" in tree:
        P["head"] = tree["head"]
    rng = np.random.default_rng(0)
    for name in tree:
        if not name.startswith("groups.0."):
            continue
        _, _, pos, sub, leaf = name.split(".")
        P["blocks"].setdefault(pos, {}).setdefault(sub, {})[leaf] = tree[name][None]
    for pos in P["blocks"]:
        if "moe" in P["blocks"][pos]:
            fine = rng.standard_normal(P["blocks"][pos]["moe"]["router"].shape) * 1e-3
            P["blocks"][pos]["moe"]["router"] = (1 + fine).astype(np.float32)
    loaded = lm_params_from_numpy(cfg, P, device="cpu", dtype=torch.bfloat16)
    for name in routers:
        assert loaded[name].dtype == torch.float32
        pos = name.split(".")[2]
        np.testing.assert_array_equal(loaded[name].numpy(), P["blocks"][pos]["moe"]["router"][0])
    assert all(loaded[k].dtype == torch.bfloat16 for k in loaded if k not in routers)
    model.load_state_dict(loaded)
    assert all(model.state_dict()[k].dtype == torch.float32 for k in routers)
    logits = model({"tokens": torch.randint(0, cfg.vocab, (2, 8))})
    assert logits.shape == (2, 8, cfg.vocab) and bool(torch.isfinite(logits.float()).all())
