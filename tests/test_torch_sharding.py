"""The port's logical-axis sharding rules and the models' specs against the
JAX package's (`repro/parallel/sharding.py`, the models' `*_specs`), on
the CPU.

The rules are pure functions of a mesh's shape and axis names, so the two
packages agree exactly: every result is held equal, as tuples, to JAX's on
a `jax.sharding.AbstractMesh` of the same shape.  The JAX side imports
`repro.parallel.sharding` and `repro.models` only (they import on jax
0.9.0).
"""

from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.transformer import Transformer, param_leaves
from repro_torch.parallel import sharding as T


def meshes(shape, axes):
    return jax.sharding.AbstractMesh(shape, axes), T.Mesh(shape, axes)


def tup(spec):
    """A PartitionSpec of either package as a plain tuple."""
    return tuple(spec)


def tree_tuples(tree):
    if isinstance(tree, dict):
        return {k: tree_tuples(v) for k, v in tree.items()}
    return tuple(tree)


# --------------------------------------------------------------------------
# tests/test_sharding.py's cases, on both packages
# --------------------------------------------------------------------------

RULE_CASES = [  # (mesh shape, axes, make_rules kwargs, arch or None)
    ((2, 2), ("data", "model"), {}, None),
    ((2, 2, 2), ("pod", "data", "model"), {}, None),
    ((2, 16), ("data", "model"), {}, "phi3-mini-3.8b"),
    ((2, 16), ("data", "model"), {}, "qwen3-8b"),
    ((2, 2), ("data", "model"), {"fsdp": False}, None),
    ((2, 2, 2), ("pod", "data", "model"), {"pod_strategy": "tp"}, None),
]


@pytest.mark.parametrize("shape, axes, kw, arch", RULE_CASES)
def test_make_rules_matches_jax(shape, axes, kw, arch):
    jm, tm = meshes(shape, axes)
    jr = J.make_rules(jm, model_cfg=jget(arch) if arch else None, **kw)
    tr = T.make_rules(tm, model_cfg=get_config(arch) if arch else None, **kw)
    assert tr.rules == jr.rules
    for logical in (None, "fsdp", "tp", "ep", "dp", "sp", "kv", "unknown"):
        assert tr.axes(logical) == jr.axes(logical)


@pytest.mark.parametrize("template", [("fsdp", "tp", None), ("dp", None), ("kv", "sp"), ()])
def test_template_to_pspec_matches_jax(template):
    jm, tm = meshes((2, 2), ("data", "model"))
    assert tup(T.template_to_pspec(template, T.make_rules(tm))) == tup(
        J.template_to_pspec(template, J.make_rules(jm)))


SANITIZE_CASES = [  # (mesh shape, axes, spec, shape): tests/test_sharding.py's, and more
    ((2, 16), ("data", "model"), ("data", "model", None), (64, 40, 128)),
    ((2, 16), ("data", "model"), ("data", "model"), (64, 32)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None), (2, 8)),
    ((2, 16), ("data", "model"), ("data", "model", None, None), (1, 524288, 8, 128)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"), (8, 3)),
    ((2, 2, 2), ("pod", "data", "model"), (("data", "pod"), None, "model"), (6, 4)),
    ((4, 1), ("data", "model"), (("data",), None), (3, 16)),
    ((4, 1), ("data", "model"), (None, "model", "data"), (3, 5)),  # a spec longer than...
    ((4, 1), ("data", "model"), ("data", None, None), (8,)),  # ...and one longer than the shape
]


@pytest.mark.parametrize("shape, axes, spec, dims", SANITIZE_CASES)
def test_sanitize_pspec_matches_jax(shape, axes, spec, dims):
    jm, tm = meshes(shape, axes)
    got = T.sanitize_pspec(T.PartitionSpec(*spec), dims, tm)
    assert tup(got) == tup(J.sanitize_pspec(JP(*spec), dims, jm))
    assert isinstance(got, T.PartitionSpec)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "hubert-xlarge", "internvl2-76b"])
def test_batch_pspecs_match_jax(arch, kind):
    jm, tm = meshes((2, 2, 2), ("pod", "data", "model"))
    want = J.batch_pspecs(jget(arch), J.make_rules(jm), kind=kind)
    got = T.batch_pspecs(get_config(arch), T.make_rules(tm), kind=kind)
    assert {k: tup(v) for k, v in got.items()} == {k: tup(v) for k, v in want.items()}


def test_tree_pspecs_and_activation_constraints():
    """tree_pspecs maps a template tree as JAX's maps it; the activation
    constraints are the identity (the port has no GSPMD)."""
    jm, tm = meshes((2, 4), ("data", "model"))
    cfg = get_config("qwen3-8b")
    jspecs = jax.tree.map(lambda t: J.template_to_pspec(t, J.make_rules(jm, model_cfg=cfg)),
                          JT.param_specs(jget("qwen3-8b")),
                          is_leaf=lambda x: isinstance(x, tuple))
    got = T.tree_pspecs(_port_param_specs(cfg), T.make_rules(tm, model_cfg=cfg))
    assert tree_tuples(got) == tree_tuples(jspecs)
    x = torch.ones(2, 3)
    with T.activation_sharding_ctx(tm, T.make_rules(tm)):
        assert T.shard_activation(x, "dp", None) is x


def _port_param_specs(cfg):
    from repro_torch.models.transformer import param_specs

    return param_specs(cfg)


# --------------------------------------------------------------------------
# The models' specs
# --------------------------------------------------------------------------

def test_every_arch_is_covered():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_match_jax(arch):
    """`param_specs` and `cache_specs` on the model (as JAX's `Model`
    exposes them) equal JAX's, leaf for leaf, as tuples; every parameter of
    the port's model has its template, under the JAX tree's key."""
    jm = jbuild(jget(arch))
    model = Transformer(get_config(arch), device="meta", dtype=torch.float32)
    assert tree_tuples(model.param_specs()) == tree_tuples(jm.param_specs())
    assert tree_tuples(model.cache_specs()) == tree_tuples(jm.cache_specs())
    flat = _flat(model.param_specs())
    assert set(param_leaves(dict(model.named_parameters()))) == set(flat)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_leaf_shapes(cfg) -> dict:
    """The JAX tree's leaf shapes of the port's model (a stacked leaf with
    its groups in front), from a model on the meta device."""
    model = Transformer(cfg, device="meta", dtype=torch.float32)
    named = dict(model.named_parameters())
    return {key: ((len(names), *named[names[0]].shape) if key.startswith("blocks/")
                  else tuple(named[names[0]].shape))
            for key, names in param_leaves(named).items()}


@pytest.mark.parametrize("mesh_shape, axes", [((16, 16), ("data", "model")),
                                              ((2, 16, 16), ("pod", "data", "model"))])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sanitized_param_pspecs_match_jax(arch, mesh_shape, axes):
    """Every parameter leaf's template, mapped by the rules and sanitized
    against its shape at the published width, as JAX maps it; the leaf
    shapes are the port model's and equal the JAX init's."""
    jm, tm = meshes(mesh_shape, axes)
    cfg, jcfg = get_config(arch), jget(arch)
    shapes = _port_leaf_shapes(cfg)
    jshapes = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
               for path, x in jax.tree_util.tree_leaves_with_path(
                   jax.eval_shape(jbuild(jcfg).init, jax.random.key(0)))}
    assert shapes == jshapes
    jrules, trules = J.make_rules(jm, model_cfg=jcfg), T.make_rules(tm, model_cfg=cfg)
    jtemplates, ttemplates = _flat(JT.param_specs(jcfg)), _flat(_port_param_specs(cfg))
    for key, shape in shapes.items():
        want = J.sanitize_pspec(J.template_to_pspec(jtemplates[key], jrules), shape, jm)
        got = T.sanitize_pspec(T.template_to_pspec(ttemplates[key], trules), shape, tm)
        assert tup(got) == tup(want), key


# --------------------------------------------------------------------------
# rank_rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape, axes, batch, want", [
    ((2, 1), ("data", "model"), 4, [[0, 1], [2, 3]]),
    ((4, 1), ("data", "model"), 8, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    ((2, 1), ("data", "model"), 3, [[0, 1, 2]] * 2),  # does not divide: every row
    ((4, 1), ("data", "model"), 2, [[0, 1]] * 4),
    ((1, 1), ("data", "model"), 5, [[0, 1, 2, 3, 4]]),
    ((2, 2), ("data", "model"), 4, [[0, 1], [0, 1], [2, 3], [2, 3]]),  # model ranks share rows
    ((2, 2, 1), ("pod", "data", "model"), 8, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    ((2, 2, 1), ("pod", "data", "model"), 2, [[0], [0], [1], [1]]),  # pod divides, data not
])
def test_rank_rows(shape, axes, batch, want):
    mesh = T.Mesh(shape, axes)
    rules = T.make_rules(mesh)
    assert [list(T.rank_rows(batch, mesh, rules, r)) for r in range(mesh.size)] == want


def test_rank_rows_follows_the_sanitized_batch_spec():
    """rank_rows' split is sanitize_pspec(batch_pspecs(...)["tokens"])'s,
    as JAX reads the batch's sharding: sharded rows where the spec keeps the
    data axis, every row where it drops it."""
    jm, tm = meshes((4, 1), ("data", "model"))
    for batch in (4, 6, 8, 12, 2):
        spec = J.sanitize_pspec(J.batch_pspecs(jget("qwen3-8b"), J.make_rules(jm))["tokens"],
                                (batch, 16), jm)
        rows = [len(T.rank_rows(batch, tm, T.make_rules(tm), r)) for r in range(4)]
        assert rows == ([batch // 4] * 4 if spec[0] is not None else [batch] * 4)
    with pytest.raises(ValueError, match="rank 4"):
        T.rank_rows(4, tm, T.make_rules(tm), 4)
