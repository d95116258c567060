"""Checkpointing with atomic commits and asynchronous writes, in the JAX
package's format (`repro/checkpoint/checkpointer.py`):

    <dir>/step_00000042.tmp/   (staging)
        leaf_0000.npy ... leaf_NNNN.npy
        manifest.json          (step, n_leaves, treedef, dtypes, shapes)
    <dir>/step_00000042/       (atomic rename on commit)
    <dir>/LATEST               (atomic pointer file)

Leaf i of a checkpoint is leaf i of the JAX `TrainState` of the same config
and optimizer, in `jax.tree.flatten`'s order: the parameters (sorted keys,
each per-group leaf stacked over the groups), then the optimizer state
(its parts and their leaves in sorted key order), then the step (int32).  So
either package restores what the other wrote.  bf16 leaves are written as
the JAX package writes them, as 2-byte void ('<V2') arrays whose manifest
dtype is "bfloat16", and read back through their bits (numpy has no bf16).

A save copies every leaf to the host before it returns (the train step
updates the tensors in place); the files are written on one worker thread.

A sharded state (`repro_torch.parallel.fsdp`: each rank holds its blocks)
is stored logically, as the JAX checkpointer stores a sharded `TrainState`:
every rank calls `save`, which gathers each cut leaf whole along both
axes, one leaf at a time, and rank 0 alone keeps the host copies and
writes them, in the format above.  Every collective finishes before `save`
returns, so none runs on the writer thread.  `restore` into a sharded
state reads each leaf whole and places the rank's block.  So a checkpoint
restores on any layout: one card, or ranks of any ("data", "model") mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.models.transformer import param_leaves
from repro_torch.parallel.fsdp import opt_leaf_shard
from repro_torch.parallel.sharding import data_dim, model_dim
from repro_torch.training.train_step import TrainState

_BF16_DESCR = "<V2"


def _sorted_keys(d: dict) -> list[str]:
    return sorted(d, key=lambda k: tuple(k.split("/")))


def state_leaves(state) -> list[tuple[str, list[torch.Tensor]]]:
    """The JAX leaves of a port `TrainState`, in order: (path, the tensors
    that hold it: one per group of a stacked parameter, else one)."""
    named = dict(state.params.named_parameters())
    out = [(f"params/{key}", [named[n] for n in names])
           for key, names in param_leaves(named).items()]
    for part in sorted(state.opt):
        out += [(f"opt/{part}/{key}", [state.opt[part][key]])
                for key in _sorted_keys(state.opt[part])]
    out.append(("step", [state.step]))
    return out


def leaf_shards(state) -> list[tuple]:
    """(Shard, lead) of each leaf of `state_leaves(state)` on a sharded
    state (`state.params.fsdp`): a parameter's tensors are its groups', an
    optimizer-state leaf's one tensor (`fsdp.opt_leaf_shard`: a moment
    stacked over the groups, lead 1; Adafactor's `vr` and `vc` the factored
    shapes' blocks); the step's Shard is None.  None for a whole state."""
    sharding = getattr(state.params, "fsdp", None)
    if sharding is None:
        return None
    leaves = param_leaves(dict(state.params.named_parameters()))
    out = []
    for path, _ in state_leaves(state):
        if path == "step":
            out.append((None, 0))
        elif path.startswith("params/"):
            out.append((sharding.layout[leaves[path[len("params/"):]][0]], 0))
        else:
            _, part, key = path.split("/", 2)
            out.append(opt_leaf_shard(sharding, leaves[key], part))
    return out


_LEAF = None


def _nest(paths: list[str]) -> dict:
    """The nested dict of "/"-joined paths, a leaf at each path's end."""
    tree: dict = {}
    for path in paths:
        *parents, last = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = _LEAF
    return tree


def flatten_up_to(state, tree) -> list:
    """`tree`'s entries at the JAX leaves of the port `TrainState` `state`, in
    `state_leaves`' order, matched as JAX's `treedef.flatten_up_to` matches
    a tree to a `TrainState`'s structure: `tree` is a `TrainState` whose
    params and opt are nested dicts with the JAX tree's keys (for example
    `repro_torch.launch.specs.train_state_pspecs`), and anything stands at
    a leaf.  A mismatch raises ValueError in JAX's words."""
    paths = [path for path, _ in state_leaves(state)]
    want = _nest(paths)
    if not isinstance(tree, TrainState):
        raise ValueError(f"Custom node type mismatch: expected type: {TrainState!r}, "
                         f"value: {tree!r}.")
    out: list = []
    for field in ("params", "opt", "step"):
        _match(want[field], getattr(tree, field), out)
    return out


def _match(want, given, out: list) -> None:
    if want is _LEAF:
        out.append(given)
        return
    if not isinstance(given, dict):
        raise ValueError(f"Expected dict, got {given!r}.")
    if sorted(given) != sorted(want):
        raise ValueError(f"Dict key mismatch; expected keys: {sorted(want)!r}; "
                         f"present keys: {sorted(given)!r}.")
    for k in sorted(want):
        _match(want[k], given[k], out)


def _host(path: str, tensors: list[torch.Tensor]) -> np.ndarray:
    """A host copy of the leaf (bf16 as its int16 bits).  Always a copy: a
    CPU tensor's `.cpu()` is the tensor itself, which the next step updates
    while the write is pending."""
    t = torch.stack(tensors) if path.startswith("params/blocks/") else tensors[0]
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def _save_leaf(path: str, x: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, x)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": x.shape})
        f.write(np.ascontiguousarray(x).tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    x = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3, async_writes: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_writes else None
        self._pending = None
        self._lock = threading.Lock()

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state) -> None:
        """Write `state` as checkpoint `step` (asynchronously unless the
        checkpointer was made with async_writes=False).  On a sharded state
        every rank calls it; rank 0 writes (module docstring)."""
        leaves = state_leaves(state)
        dtypes = [str(ts[0].dtype).removeprefix("torch.") for _, ts in leaves]
        shards = leaf_shards(state)
        if shards is None:
            host = [_host(path, ts) for path, ts in leaves]
        else:
            sharding = state.params.fsdp
            host = []
            for (path, ts), (shard, lead) in zip(leaves, shards):
                whole = [t if shard is None else sharding.whole(t, shard, lead) for t in ts]
                if sharding.rank == 0:
                    host.append(_host(path, whole))
                del whole
            if sharding.rank != 0:
                return
        treedef = "TrainState leaves: " + ", ".join(path for path, _ in leaves)
        if self._pool is None:
            self._write(step, host, dtypes, treedef)
            return
        self.wait()
        with self._lock:
            self._pending = self._pool.submit(self._write, step, host, dtypes, treedef)

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def _write(self, step: int, leaves, dtypes, treedef: str) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(leaves), "treedef": treedef,
                    "dtypes": dtypes, "shapes": [list(x.shape) for x in leaves]}
        for i, (x, dt) in enumerate(zip(leaves, dtypes)):
            _save_leaf(os.path.join(tmp, f"leaf_{i:04d}.npy"), x, dt)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._commit_pointer(name)
        self._prune()

    def _commit_pointer(self, name: str) -> None:
        ptr = os.path.join(self.dir, "LATEST")
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ptr)

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(len(steps) - self.keep_last, 0)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        step = int(name.split("_")[1])
        return step if os.path.isdir(os.path.join(self.dir, name)) else None

    @torch.no_grad()
    def restore(self, example_state, step: int | None = None, shardings=None):
        """Restore into the tensors of `example_state` (a `TrainState` of the
        same config and optimizer), in place, and return it.  Each leaf is
        cast to the tensor's dtype on the tensor's device.

        `shardings`, as in the JAX package, is a tree of the state's
        structure with a partition spec at each leaf (for example
        `repro_torch.launch.specs.train_state_pspecs(model, rules)`), checked
        leaf by leaf as JAX's `treedef.flatten_up_to` checks it
        (`flatten_up_to`: a mismatch raises ValueError).  A sharded
        `example_state` (`repro_torch.parallel.fsdp`) takes only the rank's
        block of each leaf; its layout must split each leaf where the spec
        puts "data" and "model" on its mesh (else ValueError), the MoE
        experts' "ep" dimension included.  A whole state takes every leaf
        whole, whatever the specs: the replicated data-parallel step holds
        the whole state on every rank."""
        shards = leaf_shards(example_state)
        if shardings is not None:
            specs = flatten_up_to(example_state, shardings)
            if shards is not None:
                _check_layout(example_state, specs, shards)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = state_leaves(example_state)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"{d} holds {manifest['n_leaves']} leaves, the state has "
                             f"{len(leaves)}")
        for i, (path, tensors) in enumerate(leaves):
            x = _load_leaf(os.path.join(d, f"leaf_{i:04d}.npy"), manifest["dtypes"][i])
            stacked = path.startswith("params/blocks/")
            shard, lead = (None, 0) if shards is None else shards[i]
            want = _whole_shape(tensors, stacked, shard, lead)
            if tuple(x.shape) != want:
                raise ValueError(f"{d} leaf {i} ({path}): shape {tuple(x.shape)}, the state's "
                                 f"is {want}")
            for j, t in enumerate(tensors):
                src = x[j] if stacked else x
                t.copy_(src if shard is None else shard.cut(src, lead))
        return example_state


def _whole_shape(tensors: list, stacked: bool, shard, lead: int) -> tuple:
    """The whole leaf's shape (a stacked parameter's groups in front)."""
    one = tuple(tensors[0].shape) if shard is None else (*tensors[0].shape[:lead], *shard.shape)
    return (len(tensors), *one) if stacked else one


def _check_layout(state, specs: list, shards: list) -> None:
    """Each cut leaf of the sharded `state` is split where its spec puts
    "data", and "model", on the state's mesh (the dimensions of the whole
    leaf, a stacked parameter's groups in front), and each whole leaf
    nowhere."""
    mesh = state.params.fsdp.mesh
    for (path, ts), spec, (shard, lead) in zip(state_leaves(state), specs, shards):
        stacked = path.startswith("params/blocks/")
        shape = _whole_shape(ts, stacked, shard, lead)
        fits = len(spec) == len(shape)
        lead_all = lead + int(stacked)
        for axis, got, find in (("data", None if shard is None else shard.dim, data_dim),
                                ("model", None if shard is None else shard.mdim, model_dim)):
            have = None if got is None else got + lead_all
            want = find(spec, shape, mesh) if fits else None
            if have != want:
                raise ValueError(f"{path}: the state splits dimension {have} over \"{axis}\", "
                                 f"the shardings {spec} on {mesh} dimension {want}")
