"""`Checkpointer.restore(shardings=...)` of the port: a restore onto a mesh.

The JAX package checks the shardings tree against the state's structure
(`treedef.flatten_up_to`) and places each leaf sharded; the port checks the
tree the same way, with JAX's error messages, and restores every leaf
whole into a whole state (a sharded one takes its slices:
`tests/test_torch_fsdp.py`).  The
shardings are the dry-run specs (`repro_torch.launch.specs.
train_state_pspecs`) on the production meshes.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import specs as JS
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten_up_to, state_leaves
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.training import OptConfig
from test_torch_checkpoint import jax_state, port_leaf_bits, port_state, tiny

CASES = [("qwen3-8b", "adamw", False), ("jamba-v0.1-52b", "adamw", True),
         ("falcon-mamba-7b", "adamw", False), ("qwen3-moe-235b-a22b", "adamw", True)]


def saved(tmp_path, arch, kind):
    """A checkpoint at step 5 of a state whose every leaf is drawn."""
    cfg = tiny(arch)
    state = port_state(cfg, OptConfig(kind=kind))
    for part in state.opt.values():
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state.step.fill_(5)
    ck = Checkpointer(str(tmp_path), async_writes=False)
    ck.save(5, state)
    return cfg, state, ck


def mesh_specs(state, cfg, multi_pod: bool):
    mesh = make_production_mesh(multi_pod=multi_pod)
    return TS.train_state_pspecs(state.params, make_rules(mesh, model_cfg=cfg))


@pytest.mark.parametrize("arch, kind, multi_pod", CASES)
def test_restore_onto_a_mesh_equals_a_whole_restore_bit_for_bit(tmp_path, arch, kind,
                                                                multi_pod):
    cfg, state, ck = saved(tmp_path, arch, kind)
    whole = ck.restore(port_state(cfg, OptConfig(kind=kind), seed=1))
    target = port_state(cfg, OptConfig(kind=kind), seed=2)
    onto = ck.restore(target, shardings=mesh_specs(target, cfg, multi_pod))
    assert onto is target
    want = port_leaf_bits(state)
    for a, b, w in zip(port_leaf_bits(whole), port_leaf_bits(onto), want):
        assert np.array_equal(a, w) and np.array_equal(b, w)
    assert int(onto.step) == 5


def test_the_specs_match_the_state_leaf_by_leaf():
    cfg = tiny("jamba-v0.1-52b")
    state = port_state(cfg)
    specs = flatten_up_to(state, mesh_specs(state, cfg, False))
    assert len(specs) == len(state_leaves(state))
    assert specs[-1] == () and all(isinstance(s, tuple) for s in specs)


def jax_message(arch, edit) -> str:
    """JAX's error for the same edit of its own specs tree, from the call
    its restore makes (`treedef.flatten_up_to`)."""
    jst = jax_state(arch, "float32", "adamw", "float32", 0)
    jspecs = JS.train_state_pspecs(
        jbuild(jax_state_cfg(arch)),
        J.make_rules(jax.sharding.AbstractMesh((16, 16), ("data", "model")),
                     model_cfg=jget(arch)))
    jspecs = edit(jspecs)
    with pytest.raises(ValueError) as e:
        jax.tree.structure(jst).flatten_up_to(jspecs)
    return str(e.value)


def jax_state_cfg(arch):
    from repro.configs import reduced as jreduced

    return jreduced(jget(arch), groups=2)


def drop_final_norm(specs):
    specs = copy.deepcopy(specs)
    del specs.params["final_norm"]
    return specs


def add_a_moment(specs):
    specs = copy.deepcopy(specs)
    specs.opt["u"] = specs.opt["m"]
    return specs


def extra_leaf(specs):
    specs = copy.deepcopy(specs)
    specs.params["blocks"]["pos0"]["attn"]["wz"] = specs.params["blocks"]["pos0"]["attn"]["wq"]
    return specs


def leaf_for_a_dict(specs):
    specs = copy.deepcopy(specs)
    specs.params["final_norm"] = specs.params["embed"]
    return specs


@pytest.mark.parametrize("edit", [drop_final_norm, add_a_moment, extra_leaf, leaf_for_a_dict])
def test_a_tree_of_another_structure_raises_in_jaxs_words(tmp_path, edit):
    """A missing or extra key, or a leaf where the state has a dict, raises
    the ValueError JAX's restore raises, word for word, and restores
    nothing."""
    cfg, _, ck = saved(tmp_path, "qwen3-8b", "adamw")
    target = port_state(cfg, seed=2)
    before = port_leaf_bits(target)
    with pytest.raises(ValueError) as e:
        ck.restore(target, shardings=edit(mesh_specs(target, cfg, False)))
    want = jax_message("qwen3-8b", edit)
    assert want.startswith(("Dict key mismatch; expected keys: [", "Expected dict, got"))
    if want.startswith("Expected dict"):  # the spec's repr is each package's own
        assert str(e.value).startswith("Expected dict, got PartitionSpec")
    else:
        assert str(e.value) == want
    assert all(np.array_equal(a, b) for a, b in zip(port_leaf_bits(target), before))


def test_a_tree_that_is_not_a_train_state_raises_in_jaxs_words(tmp_path):
    cfg, _, ck = saved(tmp_path, "qwen3-8b", "adamw")
    jst = jax_state("qwen3-8b", "float32", "adamw", "float32", 0)
    with pytest.raises(ValueError) as je:
        jax.tree.structure(jst).flatten_up_to({"x": 1})
    with pytest.raises(ValueError) as e:
        ck.restore(port_state(cfg), shardings={"x": 1})
    assert str(e.value) == str(je.value).replace("repro.training", "repro_torch.training")
