"""The port's dry-run specs (`repro_torch.launch.{mesh,specs}`) against the
JAX package's `repro.launch.specs` and `repro.parallel.sharding`, on the
CPU, in the test process.

Everything here is a pure function of a config, a mesh's shape and axis
names, or a leaf's shape, so the two packages agree exactly: the analytic
`model_flops`, `opt_config_for`, the state's, caches' and batch's partition
specs (as tuples, on `jax.sharding.AbstractMesh`es of the production
shapes) and the specs sanitized against every leaf's full-width shape (the
JAX leaves from `jax.eval_shape`, the port's from tensors on the meta
device).  `repro.launch.dryrun` and `repro.launch.perf` force 512 host
devices when imported, so they are never imported here
(`tests/test_torch_dryrun.py` runs them in a subprocess).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget
from repro.launch import mesh as JM
from repro.launch import specs as JS
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro_torch.checkpoint.checkpointer import flatten_up_to, state_leaves
from repro_torch.configs import ARCHS, applicable_shapes, get_config, reduced
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as TS
from repro_torch.models.transformer import Transformer
from repro_torch.parallel import sharding as T

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16"]
N_DEVICES = [1, 16, 256, 512]


def tree_tuples(tree):
    if isinstance(tree, dict):
        return {k: tree_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def meshes(shape, axes):
    return jax.sharding.AbstractMesh(shape, axes), T.Mesh(shape, axes)


def meta_model(arch: str) -> Transformer:
    cfg = get_config(arch)
    return Transformer(cfg, device="meta", dtype=getattr(torch, cfg.param_dtype), backend="ref")


def cells():
    return [(a, s) for a in sorted(ARCHS) for s in applicable_shapes(get_config(a))]


# --------------------------------------------------------------------------
# launch/mesh.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_its_label(multi_pod):
    """The port's abstract production mesh has the JAX mesh's shape and axis
    names, and `mesh_label` gives JAX's label (JAX's reads `mesh.devices`,
    so it is called on a stand-in with a devices array of that shape)."""
    mesh = TM.make_production_mesh(multi_pod=multi_pod)
    shape, axes = MESHES[multi_pod]
    assert (mesh.axis_sizes, mesh.axis_names) == (shape, axes)
    jlabel = JM.mesh_label(SimpleNamespace(devices=np.empty(shape)))
    assert TM.mesh_label(mesh) == jlabel == ("2x16x16" if multi_pod else "16x16")


# --------------------------------------------------------------------------
# opt_config_for, model_flops
# --------------------------------------------------------------------------

def test_every_cell_is_covered():
    assert sorted(ARCHS) == sorted(JARCHS)
    for arch in ARCHS:
        assert applicable_shapes(get_config(arch)) == japplicable(jget(arch))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_config_for_matches_jax(arch):
    got, want = TS.opt_config_for(get_config(arch)), JS.opt_config_for(jget(arch))
    assert (got.kind, got.moment_dtype) == (want.kind, want.moment_dtype)
    assert got.moment_dtype == ("bfloat16" if get_config(arch).n_params > 1e11 else "float32")


@pytest.mark.parametrize("n_devices", N_DEVICES)
@pytest.mark.parametrize("arch, shape", cells())
def test_model_flops_matches_jax(arch, shape, n_devices):
    got = TS.model_flops(get_config(arch), shape, n_devices)
    assert got == JS.model_flops(jget(arch), shape, n_devices) and got > 0
    assert TS._attn_layers(get_config(arch)) == JS._attn_layers(jget(arch))


# --------------------------------------------------------------------------
# The partition specs, as tuples
# --------------------------------------------------------------------------

def rules_for(arch, shape, axes):
    jm, tm = meshes(shape, axes)
    return (J.make_rules(jm, model_cfg=jget(arch)), T.make_rules(tm, model_cfg=get_config(arch)),
            jm, tm)


@pytest.mark.parametrize("mesh_shape, axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_state_pspecs_match_jax(arch, mesh_shape, axes):
    jr, tr, _, _ = rules_for(arch, mesh_shape, axes)
    want = JS.train_state_pspecs(jbuild(jget(arch)), jr)
    got = TS.train_state_pspecs(meta_model(arch), tr)
    assert isinstance(got, TS.TrainState)
    assert tree_tuples(got.params) == tree_tuples(want.params)
    assert tree_tuples(got.opt) == tree_tuples(want.opt)
    assert tuple(got.step) == tuple(want.step) == ()


@pytest.mark.parametrize("mesh_shape, axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_pspecs_match_jax(arch, mesh_shape, axes):
    jr, tr, _, _ = rules_for(arch, mesh_shape, axes)
    assert tree_tuples(TS.cache_pspecs(meta_model(arch), tr)) == tree_tuples(
        JS.cache_pspecs(jbuild(jget(arch)), jr))
    for shape in applicable_shapes(get_config(arch)):
        assert tree_tuples(TS.batch_specs_for(get_config(arch), shape, tr)) == tree_tuples(
            JS.batch_specs_for(jget(arch), shape, jr)), shape


# --------------------------------------------------------------------------
# The specs sanitized against every leaf's full-width shape
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_train_state(arch):
    """JAX's abstract TrainState of the full config: (leaf shapes in
    `jax.tree.flatten` order, the model)."""
    model = jbuild(jget(arch))
    state = JS.abstract_train_state(model, JS.opt_config_for(jget(arch)))
    return [tuple(x.shape) for x in jax.tree.leaves(state)], model


def port_leaf_shapes(state) -> list[tuple]:
    return [(len(ts), *ts[0].shape) if path.startswith("params/blocks/") else tuple(ts[0].shape)
            for path, ts in state_leaves(state)]


@pytest.mark.parametrize("mesh_shape, axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sanitized_train_state_specs_match_jax(arch, mesh_shape, axes):
    """Leaf for leaf of the train state (parameters, both moments, step), in
    `jax.tree.flatten`'s order: the port's meta leaf has JAX's shape, and
    its spec (matched by `flatten_up_to`, as a restore onto the mesh matches
    it) sanitized against that shape equals JAX's."""
    jr, tr, jm, tm = rules_for(arch, mesh_shape, axes)
    jshapes, jmodel = jax_train_state(arch)
    jspecs = jax.tree.leaves(JS.train_state_pspecs(jmodel, jr),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    model = meta_model(arch)
    state = TS.abstract_train_state(model, TS.opt_config_for(get_config(arch)))
    shapes = port_leaf_shapes(state)
    specs = flatten_up_to(state, TS.train_state_pspecs(model, tr))
    assert shapes == jshapes and len(specs) == len(jspecs)
    assert all(t.device.type == "meta" for _, ts in state_leaves(state) for t in ts)
    for shape, spec, jspec in zip(shapes, specs, jspecs):
        assert tuple(T.sanitize_pspec(spec, shape, tm)) == tuple(
            J.sanitize_pspec(jspec, shape, jm)), shape


@pytest.mark.parametrize("mesh_shape, axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch, shape", cells())
def test_sanitized_cache_and_batch_specs_match_jax(arch, shape, mesh_shape, axes):
    """A cell's inputs and (for decode) caches: meta tensors of JAX's shapes,
    the same dtypes except the port's int64 tokens and labels (JAX's are
    int32), and JAX's sanitized specs."""
    jr, tr, jm, tm = rules_for(arch, mesh_shape, axes)
    cfg, jcfg = get_config(arch), jget(arch)
    batch, jbatch = TS.input_specs(cfg, shape), JS.input_specs(jcfg, shape)
    assert sorted(batch) == sorted(jbatch)
    bspecs, jbspecs = TS.batch_specs_for(cfg, shape, tr), JS.batch_specs_for(jcfg, shape, jr)
    for k, t in batch.items():
        assert t.device.type == "meta" and tuple(t.shape) == jbatch[k].shape
        want_dtype = "int64" if str(jbatch[k].dtype) == "int32" else str(jbatch[k].dtype)
        assert str(t.dtype).removeprefix("torch.") == want_dtype
        assert tuple(T.sanitize_pspec(bspecs[k], tuple(t.shape), tm)) == tuple(
            J.sanitize_pspec(jbspecs[k], jbatch[k].shape, jm))
    if TS.SHAPES[shape].kind != "decode":
        return
    model, jmodel = meta_model(arch), jbuild(jcfg)
    caches, jcaches = TS.abstract_caches(model, shape), JS.abstract_caches(jmodel, shape)
    cspecs, jcspecs = TS.cache_pspecs(model, tr), JS.cache_pspecs(jmodel, jr)
    for pos, part in caches.items():
        for k, t in part.items():
            assert t.device.type == "meta" and tuple(t.shape) == jcaches[pos][k].shape
            assert str(t.dtype).removeprefix("torch.") == str(jcaches[pos][k].dtype)
            assert tuple(T.sanitize_pspec(cspecs[pos][k], tuple(t.shape), tm)) == tuple(
                J.sanitize_pspec(jcspecs[pos][k], jcaches[pos][k].shape, jm))


def test_the_specs_take_the_meta_device_only():
    cfg = get_config("qwen3-8b")
    model = Transformer(reduced(cfg), device="cpu", dtype=torch.float32, backend="ref")
    with pytest.raises(ValueError, match="meta device"):
        TS.abstract_train_state(model, TS.opt_config_for(cfg))
    with pytest.raises(ValueError, match="meta device"):
        TS.abstract_caches(model, "decode_32k")
