"""The port's dry run (`repro_torch.launch.dryrun`, `repro_torch.launch.perf`)
against the JAX package's on the smoke cells of `tests/test_dryrun_smoke.py`:
the reduced qwen3-moe, a 4x4 ("data", "model") mesh, `train_4k` at S = 128,
B = 16 and `decode_32k` at S = 256, B = 16, accum = 2; and `prefill_32k` at
S = 64, B = 8.

The JAX side (`repro.launch.dryrun.lower_cell`, which forces 512 host
devices when imported) runs in `tests/multidev/jax_dryrun_cases.py`, a
subprocess started by the fixture while the port counts its cells here.

What the port counts, and how it stands to JAX's numbers on these cells:
- `model_flops` is JAX's analytic formula: equal.
- `memory.argument_bytes` is JAX's `memory.argument_bytes` plus 4 bytes for
  every token and label a device holds: the port's are int64, JAX's int32
  (train: 4096 bytes, decode: 16 bytes a device).
- `hlo.dot_flops`: one rank's program, tensor- and expert-parallel along
  "model" (`repro_torch.parallel.tensor`).  On the data-only 4x1 mesh it
  equals, exactly, JAX's per-device `dot_flops`; on 4x4 it equals that
  count less the share of the products that "model" splits (the query
  heads, their attention and wo, the head's vocab and the MoE experts: 3/4
  of each; the K/V projections of the 2 KV heads the 4-way axis cannot
  split: 1/2, each rank projecting the one KV head its query head reads),
  derived from the shapes below.  That lands below JAX's 4x4 count, and
  the gap is one site, derived from the shapes too: GSPMD's per-device
  program projects both KV heads on every rank (forward, remat recompute
  and the input gradient), while it takes wk's and wv's weight gradient
  over the rank's quarter of d_model, where the port's rank takes it over
  the whole d_model of the gathered leaf for its one KV head.  The port's
  JAX-mesh view (its count over the ranks that repeat it) is pinned to
  the ratio of the two integer counts.
- The FLOP comparison runs the train cell with 4 dispatch groups on both
  sides.  So do the decode and prefill cells, whose rank serves on the
  sharded state (4 of the 16 rows, 2 of the 8; the layers on its "model"
  blocks): on 4x4 their count is the rank's count whole along "model" (the
  4x1 mesh's) less the share the 4 ranks along "model" split, derived from
  the shapes (`serve_split_flops`), and their JAX-mesh view is pinned to
  JAX's 4x4 count as the ratio of the two integer counts.
- The smoke config's own 2 MoE dispatch groups on 4 data ranks (the train
  cell, and the serving cells "g2"): each group's rows lie on a span of 2
  ranks, and the port's rank dispatches its whole group from the span's
  gathered choices (`repro_torch.models.layers.moe`).  Its count is the
  4-group cell's plus the experts' products on the group's larger capacity
  (`span_expert_flops`, from the shapes); JAX's per-device program runs
  both groups on every data rank (`sanitize_pspec` drops "data" from G),
  and the ratio of the two counts is pinned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from math import prod
from pathlib import Path
from unittest import mock

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as C
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.launch.mesh import make_production_mesh, mesh_label
from repro_torch.models.layers.moe import DataSplit
from repro_torch.models.transformer import Transformer
from repro_torch.parallel.sharding import Mesh

ROOT = Path(__file__).resolve().parents[1]
SMOKE_SHAPES = {"train_4k": (128, 16), "decode_32k": (256, 16), "prefill_32k": (64, 8)}
SMOKE_ARCH = "qwen3-moe-235b-a22b"
# name -> (mesh shape, shape, n_dispatch_groups or None, remat), as the JAX script's
CELLS = {
    "4x4/train": ((4, 4), "train_4k", None, True),
    "4x4/train/noremat": ((4, 4), "train_4k", None, False),
    "4x4/decode": ((4, 4), "decode_32k", 4, True),
    "4x4/prefill": ((4, 4), "prefill_32k", 4, True),
    "4x4/decode/g2": ((4, 4), "decode_32k", None, True),
    "4x4/prefill/g2": ((4, 4), "prefill_32k", None, True),
    "4x4/train/g4": ((4, 4), "train_4k", 4, True),
    "4x4/train/g4/noremat": ((4, 4), "train_4k", 4, False),
    "4x1/train/g4": ((4, 1), "train_4k", 4, True),
    "4x1/train/g4/noremat": ((4, 1), "train_4k", 4, False),
}
# The port's JAX-mesh view of the dot FLOPs over JAX's 4x4 dot_flops, as the
# ratio of two integer counts of deterministic programs (measured: the port's
# view 106,954,752 / 81,788,928 / 233,472 / 5,775,360 against JAX's
# 117,440,512 / 88,080,384 / 249,856 / 6,299,648; with the config's 2
# dispatch groups, each on a span of 2 data ranks, SPAN_PORT_FLOPS against
# JAX's SPAN_JAX_FLOPS).  Every cell's rank runs on its "data" and "model"
# blocks: the train cells' the tensor- and expert-parallel step, the decode
# and prefill cells' the sharded serving pass, whose count
# `test_a_serving_ranks_program_is_the_data_only_rank_less_the_model_split`
# derives from the shapes; a span cell's is its 4-group cell's plus
# `span_expert_flops`.
SPAN_PORT_FLOPS = {"4x4/train": 138_412_032, "4x4/train/noremat": 105_381_888,
                   "4x4/decode/g2": 307_200, "4x4/prefill/g2": 7_741_440}
SPAN_JAX_FLOPS = {"4x4/train": 155_189_248, "4x4/train/noremat": 108_527_616,
                  "4x4/decode/g2": 274_432, "4x4/prefill/g2": 10_625_024}
FLOP_RATIO = {"4x4/train/g4": 106_954_752 / 117_440_512,
              "4x4/train/g4/noremat": 81_788_928 / 88_080_384,
              "4x4/decode": 233_472 / 249_856,
              "4x4/prefill": 5_775_360 / 6_299_648,
              **{k: SPAN_PORT_FLOPS[k] / SPAN_JAX_FLOPS[k] for k in SPAN_PORT_FLOPS}}


def groups(n):
    if n is None:
        return None
    return lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_dispatch_groups=n))


def smoke():
    """The port's configs and shapes patched to the smoke cell's ("smoke")."""
    shapes = {k: dataclasses.replace(C.SHAPES[k], seq_len=S, global_batch=B)
              for k, (S, B) in SMOKE_SHAPES.items()}
    arch = {"smoke": reduced(get_config(SMOKE_ARCH), groups=2)}
    return mock.patch.dict(C.SHAPES, shapes), mock.patch.dict(C.ARCHS, arch)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script, started at once; `jax_cells` waits for it."""
    out = tmp_path_factory.mktemp("jax_dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "tests/multidev/jax_dryrun_cases.py", str(out)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port_cells(jax_run):
    s, a = smoke()
    with s, a:
        return {name: dr.lower_cell("smoke", shape, Mesh(ms, ("data", "model")), accum=2,
                                    remat=remat, cfg_override=groups(n))[0]
                for name, (ms, shape, n, remat) in CELLS.items()}


@pytest.fixture(scope="module")
def jax_cells(jax_run):
    proc, out = jax_run
    log, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, log[-4000:]
    return json.loads(out.read_text())


# --------------------------------------------------------------------------
# The records against JAX's
# --------------------------------------------------------------------------

def span_expert_flops(cfg, kind: str, rows: int, S: int, accum: int, M: int, remat: bool,
                      D: int = 4) -> int:
    """The dot FLOPs by which a rank's program with the config's dispatch
    groups, each on a span of D / G ranks, exceeds the same program with
    D groups (one a rank), from the shapes: the rank's E / M experts run on
    its group's whole capacity instead of its own group's, forward (and
    the remat recompute) and twice in the backward for a train step.  The
    routing and the combine run on the rank's own tokens either way."""
    from repro_torch.models.layers.moe import dispatch_shape

    tokens = 1 if kind == "decode" else S
    G, _, cap = dispatch_shape(cfg, rows * D, tokens)
    G4, _, cap4 = dispatch_shape(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_dispatch_groups=D)), rows * D, tokens)
    assert D % G == 0 and G < D and G4 == D  # a span of D / G ranks against one group a rank
    per_slot = 2 * cfg.d_model * 3 * cfg.moe.d_ff_expert * (cfg.moe.n_experts // M)
    passes = (4 if remat else 3) * accum if kind == "train" else 1
    return cfg.n_groups * passes * per_slot * (cap - cap4)


@pytest.mark.parametrize("name, base", [("4x4/train", "4x4/train/g4"),
                                        ("4x4/train/noremat", "4x4/train/g4/noremat"),
                                        ("4x4/decode/g2", "4x4/decode"),
                                        ("4x4/prefill/g2", "4x4/prefill")])
def test_the_smoke_cells_run_their_two_dispatch_groups_on_spans_of_two_ranks(
        port_cells, jax_cells, name, base):
    """The smoke config's 2 dispatch groups over 4 data ranks: each group's
    rows lie on a span of 2 ranks, whose choices the rank all-gathers along
    "data" (once a layer a pass: forward and remat recompute), so the record
    is `ok`.  Its dot FLOPs are the 4-group cell's plus the experts on the
    group's whole capacity (`span_expert_flops`); its model FLOPs are
    JAX's, and its argument bytes JAX's but for the int64 tokens."""
    rec, ms = port_cells[name], CELLS[name][0]
    kind, shape = CELLS[name][1].split("_")[0], CELLS[name][1]
    assert rec["ok"] is True and rec["rank"]["data_shards"] == 4
    cfg = reduced(get_config(SMOKE_ARCH), groups=2)
    S, B = SMOKE_SHAPES[shape]
    accum = 2 if kind == "train" else 1
    rows = B // accum // 4
    remat = not name.endswith("noremat")
    extra = span_expert_flops(cfg, kind, rows, S, accum, M=4, remat=remat)
    assert rec["hlo"]["dot_flops"] == port_cells[base]["hlo"]["dot_flops"] + extra
    assert rec["hlo"]["dot_flops"] == SPAN_PORT_FLOPS[name]
    assert rec["roofline"]["model_flops"] == jax_cells["cells"][name]["model_flops"]
    gap = token_bytes_over_jax(shape, Mesh(ms, ("data", "model")))
    assert rec["memory"]["argument_bytes"] - jax_cells["cells"][name]["memory"][
        "argument_bytes"] == gap
    # the choices: the other rank's int64 [tokens, K], once a MoE layer a pass
    tokens = rows * (1 if kind == "decode" else S)
    passes = accum * (2 if kind == "train" and remat else 1) * cfg.n_groups
    site = rec["hlo"]["collective_by_site"]["moe-choices"]
    assert site == {"bytes": passes * tokens * cfg.moe.top_k * 8 * (2 - 1), "calls": passes}
    assert jax_cells["cells"][name]["hlo"]["dot_flops"] == SPAN_JAX_FLOPS[name]


@pytest.mark.parametrize("name", ["4x4/train/g4", "4x4/decode", "4x4/prefill", "4x4/train",
                                  "4x4/decode/g2", "4x4/prefill/g2"])
def test_model_flops_equal_jax(port_cells, jax_cells, name):
    got = port_cells[name]["roofline"]["model_flops"]
    assert got == jax_cells["cells"][name]["model_flops"]
    # the dispatch groups do not enter the analytic count
    assert jax_cells["cells"]["4x4/train"]["model_flops"] == jax_cells["cells"][
        "4x4/train/g4"]["model_flops"] == 63_504_384


def token_bytes_over_jax(cfg_shape: str, mesh: Mesh) -> int:
    """4 bytes for each token and label element a device holds: the port's
    int64 against JAX's int32, rows sharded over "data"."""
    S, B = SMOKE_SHAPES[cfg_shape]
    per_dev_rows = B // mesh.shape["data"]
    if cfg_shape == "decode_32k":
        return 4 * per_dev_rows
    if cfg_shape == "prefill_32k":
        return 4 * per_dev_rows * S  # tokens
    return 4 * 2 * per_dev_rows * S  # tokens and labels


@pytest.mark.parametrize("name, gap", [("4x4/train/g4", 4096), ("4x4/decode", 16),
                                       ("4x1/train/g4", 4096), ("4x4/prefill", 512),
                                       ("4x4/train", 4096), ("4x4/decode/g2", 16),
                                       ("4x4/prefill/g2", 512)])
def test_argument_bytes_equal_jax_but_for_the_int64_tokens(port_cells, jax_cells, name, gap):
    ms, shape, _, _ = CELLS[name]
    assert token_bytes_over_jax(shape, Mesh(ms, ("data", "model"))) == gap
    rec, want = port_cells[name], jax_cells["cells"][name]["memory"]["argument_bytes"]
    assert rec["memory"]["argument_bytes"] - want == gap
    assert rec["memory"]["token_dtype"] == "int64"
    if name.startswith("4x4/train"):  # JAX's figure on the cell as it runs it (2 groups)
        assert jax_cells["cells"]["4x4/train"]["memory"]["argument_bytes"] == want == 100_868


@pytest.mark.parametrize("name", sorted(FLOP_RATIO))
def test_flop_ratio_to_jax_dot_flops_is_pinned(port_cells, jax_cells, name):
    """The view is the rank's count over the ranks that repeat its program:
    none on these cells (4 data shards, 4 ranks along "model" splitting the
    work: the train step's, and since the serving rank runs on its blocks,
    the decode and prefill passes')."""
    rec = port_cells[name]
    view = rec["hlo"]["dot_flops_jax_view"]
    repetition = 1
    assert rec["rank"]["repetition"] == repetition and rec["rank"]["data_shards"] == 4
    assert view == rec["hlo"]["dot_flops"] / repetition
    ratio = view / jax_cells["cells"][name]["hlo"]["dot_flops"]
    assert ratio == pytest.approx(FLOP_RATIO[name], rel=1e-12)


def tp_split_flops(cfg, rows: int, S: int, accum: int, M: int, remat: bool,
                   D: int = 4) -> float:
    """The dot FLOPs that M ranks along "model" take off one rank's program
    on `rows` rows of S tokens a micro-batch, from the shapes: each group's
    query projection, attention (the plain version's QK^T and PV over every
    key), wo and MoE experts, and the head, (M - 1) / M of each; the K/V
    projections, (M - 1) / M where kv -> "model", else 1 - n / KV, n the KV
    heads that a rank's H / M query heads read.  The experts run on the
    rank's dispatch groups' `cap` slots each (`dispatch_shape` of the
    micro-batch of D ranks' rows, the rank's share of its groups).  A
    group's product runs forward, in the remat recompute and twice in the
    backward; the head's has no recompute."""
    from repro_torch.models.layers.moe import dispatch_shape

    T, d, H, KV, hd = rows * S, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = wo = 2 * T * d * H * hd
    attn = 2 * (2 * rows * S * S * H * hd)
    kv = 2 * (2 * T * d * KV * hd)
    kv_split = (M - 1) / M if KV % M == 0 else 1 - max(1, (H // M) // (H // KV)) / KV
    G, per_group, cap = dispatch_shape(cfg, rows * D, S)  # the micro-batch's groups
    experts = cfg.moe.n_experts * 2 * (G // D) * cap * d * 3 * cfg.moe.d_ff_expert
    assert per_group * (G // D) == T
    per_group_split = (M - 1) / M * (q + attn + wo + experts) + kv_split * kv
    head = (M - 1) / M * 2 * T * d * cfg.vocab
    return accum * (cfg.n_groups * (4 if remat else 3) * per_group_split + 3 * head)


def kv_gap_flops(cfg, rows: int, S: int, accum: int, D: int, remat: bool) -> float:
    """The dot FLOPs by which JAX's 4x4 per-device program exceeds the port's
    rank, from the shapes: the K/V projections of the KV heads a 4-way
    model axis cannot split.  GSPMD's program projects all KV heads on every
    rank in the forward (and the remat recompute) and in the input
    gradient, where the port's rank projects the one its query head reads;
    and GSPMD takes wk's and wv's weight gradient over the rank's 1 / D of
    d_model for every KV head, where the port takes it over the whole
    d_model of the gathered leaf for its one."""
    T, d, KV, hd = rows * S, cfg.d_model, cfg.n_kv, cfg.head_dim
    forward = 2 * (2 * T * d * (KV - 1) * hd)  # k and v
    input_grad = forward
    weight_grad = 2 * (2 * T * d * hd) - 2 * (2 * T * (d // D) * KV * hd)  # the port's more
    return accum * cfg.n_groups * ((2 if remat else 1) * forward + input_grad - weight_grad)


def serve_split_flops(cfg, kind: str, rows: int, S: int, M: int, D: int = 4) -> float:
    """The dot FLOPs that M ranks along "model" take off a serving rank's
    pass on `rows` rows (decode: one token each against a cache of S;
    prefill: S tokens each), from the shapes: each group's query
    projection, attention (QK^T and PV over every key: the cache's S, or
    the prompt's in the plain version; a decode step's rank scores every
    query head against its S / M keys of the caches' sequence, the same
    share), wo and MoE experts, and the head (the last position's logits),
    (M - 1) / M of each; the K/V projections, (M - 1) / M where kv ->
    "model", and where it was dropped: a prefill's rank projects the KV
    heads its query heads read over the prompt (`tp_split_flops`' share
    off) and every KV head at its block of S / M positions for its caches
    (`cache_block`, a share back on); a decode step's rank projects the
    token's k and v only where its block of the caches holds the position
    (rank 0 at S - 1 does not: all of them off).  The experts run on the
    rank's dispatch groups' `cap` slots each (`dispatch_shape` of the D
    ranks' rows)."""
    from repro_torch.models.layers.moe import dispatch_shape

    assert S % M == 0  # the caches' sequence split along "model"
    tokens = 1 if kind == "decode" else S
    T, d, H, KV, hd = rows * tokens, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = wo = 2 * T * d * H * hd
    attn = 2 * (2 * T * S * H * hd)
    kv = 2 * (2 * T * d * KV * hd)
    cache_kv = 0
    if KV % M == 0:
        kv_split = (M - 1) / M
    elif kind == "decode":
        kv_split = 1
    else:
        kv_split = 1 - max(1, (H // M) // (H // KV)) / KV
        cache_kv = 2 * (2 * rows * (S // M) * d * KV * hd)
    G, _, cap = dispatch_shape(cfg, rows * D, tokens)
    experts = cfg.moe.n_experts * 2 * (G // D) * cap * d * 3 * cfg.moe.d_ff_expert
    head = 2 * rows * d * cfg.vocab
    return cfg.n_groups * ((M - 1) / M * (q + attn + wo + experts) + kv_split * kv
                           - cache_kv) + (M - 1) / M * head


@pytest.mark.parametrize("name, whole_along_model, split", [
    ("4x4/decode", 987_136, 753_664), ("4x4/prefill", 18_513_920, 12_738_560)])
def test_a_serving_ranks_program_is_the_data_only_rank_less_the_model_split(
        port_cells, name, whole_along_model, split):
    """Exactly: the 4x4 serving rank's count is the 4x1 rank's (the same
    rows, 4 of 16 to decode, 2 of 8 to prefill, whole along "model") less
    what the 4 ranks along "model" split (`serve_split_flops`)."""
    ms, shape, n, _ = CELLS[name]
    cfg = groups(n)(reduced(get_config(SMOKE_ARCH), groups=2))
    s, a = smoke()
    with s, a:
        data_only, _ = dr.lower_cell("smoke", shape, Mesh((4, 1), ("data", "model")),
                                     cfg_override=groups(n))
    rows, S = data_only["rank"]["rows"], SMOKE_SHAPES[shape][0]
    assert rows == port_cells[name]["rank"]["rows"] == SMOKE_SHAPES[shape][1] // 4
    assert data_only["hlo"]["dot_flops"] == whole_along_model
    assert serve_split_flops(cfg, name.split("/")[1], rows, S, M=4) == split
    assert port_cells[name]["hlo"]["dot_flops"] == whole_along_model - split


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_the_smoke_serving_cells_with_two_dispatch_groups_run_on_spans(port_cells, shape):
    """The smoke config's 2 MoE dispatch groups over 4 data ranks: a
    sharded serving rank dispatches its group's whole capacity from the
    choices of the 2 ranks its group spans, so the cell is `ok`, its
    choices' all-gathers counted along "data" (one a MoE layer).  Its wire
    differs from the 4-group cell's by those gathers and by the all-gather
    of the experts' outputs along "model" over the group's larger capacity;
    its rank holds the same bytes."""
    from repro_torch.models.layers.moe import dispatch_shape

    name = f"4x4/{shape.split('_')[0]}/g2"
    rec, base = port_cells[name], port_cells[name[:-3]]
    assert rec["ok"] is True and rec["accum"] is None
    cfg = reduced(get_config(SMOKE_ARCH), groups=2)
    site = rec["hlo"]["collective_by_site"]["moe-choices"]
    assert site["calls"] == cfg.n_groups
    assert base["hlo"]["collective_by_site"] == {}

    def gathers(r, axis):
        return r["hlo"]["collective_by_axis"][axis]["all-gather"]

    S, B = SMOKE_SHAPES[shape]
    tokens = 1 if shape == "decode_32k" else S
    cap = dispatch_shape(cfg, B, tokens)[2]
    cap4 = dispatch_shape(groups(4)(cfg), B, tokens)[2]
    y = cfg.n_groups * cfg.moe.n_experts * (cap - cap4) * cfg.d_model * 4 * 3 / 4
    assert gathers(rec, "data") == gathers(base, "data") + site["bytes"]
    assert gathers(rec, "model") == gathers(base, "model") + y
    assert rec["hlo"]["collective_wire_bytes"] == (base["hlo"]["collective_wire_bytes"]
                                                   + site["bytes"] + y)
    assert rec["memory"]["port_rank_bytes"] == base["memory"]["port_rank_bytes"]


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_serving_wire_bytes_equal_the_sum_of_the_collective_wrappers_calls(shape):
    """A serving cell's record on 2x2: its wire bytes by axis and kind and
    its sites are those of every collective call of its pass."""
    from repro_torch.parallel import fsdp

    seen: dict = {}
    calls = []
    orig = fsdp._collective

    def spy(kind, nbytes, ranks, group, t, run, axis="data"):
        if ranks > 1:
            mine = seen.setdefault(axis, dict.fromkeys(fsdp.KINDS, 0.0))
            mine[kind] += (2 if kind == "all-reduce" else 1) * (ranks - 1) / ranks * nbytes
            calls.append(kind)
        return orig(kind, nbytes, ranks, group, t, run, axis)

    s, a = smoke()
    with s, a, mock.patch.object(fsdp, "_collective", spy):
        rec, _ = dr.lower_cell("smoke", shape, Mesh((2, 2), ("data", "model")),
                               cfg_override=groups(4))
    assert rec["hlo"]["collective_by_axis"] == seen and set(seen) == {"data", "model"}
    assert rec["hlo"]["collective_wire_bytes"] == sum(sum(v.values()) for v in seen.values())
    assert rec["hlo"]["n_collective_sites"] == len(calls) > 0


@pytest.mark.parametrize("remat", ["", "/noremat"])
def test_a_ranks_program_is_jaxs_per_device_program_on_a_data_only_mesh(port_cells, jax_cells,
                                                                        remat):
    """Exactly: the rank's program on 4x1 is JAX's per-device program there
    (the same rows, no model axis), and on 4x4 it is that count less what
    the 4 ranks along "model" split (`tp_split_flops`: 281,018,368 FLOPs
    with remat, 215,482,368 without, of which the experts' 94,371,840 and
    70,778,880).  That lands below JAX's 4x4 per-device count by
    `kv_gap_flops` (10,485,760 and 6,291,456): the K/V projections of the
    2 KV heads a 4-way axis cannot split (module docstring)."""
    jax41 = jax_cells["cells"][f"4x1/train/g4{remat}"]["hlo"]["dot_flops"]
    cfg = groups(4)(reduced(get_config(SMOKE_ARCH), groups=2))
    split = tp_split_flops(cfg, rows=2, S=128, accum=2, M=4, remat=not remat)
    assert split == (215_482_368 if remat else 281_018_368)
    assert port_cells[f"4x1/train/g4{remat}"]["hlo"]["dot_flops"] == jax41
    assert port_cells[f"4x4/train/g4{remat}"]["hlo"]["dot_flops"] == jax41 - split
    jax44 = jax_cells["cells"][f"4x4/train/g4{remat}"]["hlo"]["dot_flops"]
    gap = kv_gap_flops(cfg, rows=2, S=128, accum=2, D=4, remat=not remat)
    assert gap == (6_291_456 if remat else 10_485_760)
    assert jax41 - split == jax44 - gap


def test_remat_adds_one_forward_of_every_group(port_cells):
    """The rank's count with remat is its count without plus one forward of
    every group, as the rank runs it (its blocks, in its model region), on
    each of its micro-batches (2 rows of 128, 4 ranks share a micro-batch's
    dispatch groups)."""
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import make_rules

    cfg = groups(4)(reduced(get_config(SMOKE_ARCH), groups=2))
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    mesh = Mesh((4, 4), ("data", "model"))
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, 0))
    x = torch.empty(2, 128, cfg.d_model, device="meta")
    positions = torch.arange(128, device="meta")
    with FlopCounterMode(display=False) as fc:
        for g in range(len(model.groups)):
            model._group_fn(g)(cfg, x, positions, backend="ref", data_split=DataSplit(4))
    accum = 2
    got = port_cells["4x4/train/g4"]["hlo"]["dot_flops"]
    assert got == port_cells["4x4/train/g4/noremat"]["hlo"]["dot_flops"] + accum * (
        fc.get_total_flops()) and fc.get_total_flops() > 0


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4)])
def test_the_ranks_shares_sum_to_the_one_device_step(mesh_shape):
    """`accumulate_grads(place=(mesh, rank))`, the program a dry run counts:
    summed over the mesh's ranks (the all-reduce the dry run leaves out), the
    loss and gradients are the one-device step's on the whole batch; ranks
    along "model" hold the same rows and split their loss."""
    from repro_torch.models import build_model
    from repro_torch.training.train_step import accumulate_grads

    cfg = reduced(get_config("qwen3-8b"), groups=1)
    model = build_model(cfg, device="cpu", backend="ref").train().requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (8, 8), generator=gen) for k in ("tokens", "labels")}
    loss1, grads1 = accumulate_grads(model, batch, accum=2)
    mesh = Mesh(mesh_shape, ("data", "model"))
    shares = [accumulate_grads(model, batch, accum=2, place=(mesh, r)) for r in range(mesh.size)]
    torch.testing.assert_close(sum(s[0] for s in shares), loss1, rtol=1e-5, atol=0)
    for name, g in grads1.items():
        torch.testing.assert_close(sum(s[1][name] for s in shares), g, rtol=1e-4, atol=1e-6)


def test_parameter_count_is_the_jax_trees_not_the_analytic_one(port_cells):
    """91,008 parameters: the JAX tree's leaf sizes summed; the analytic
    `n_params` (90,880) leaves out the q/k norm scales and the final norm."""
    leaves = jax.tree.leaves(jax.eval_shape(
        jbuild(jreduced(jget(SMOKE_ARCH), groups=2)).init, jax.random.key(0)))
    rec = port_cells["4x4/decode"]
    assert rec["n_params"] == sum(prod(x.shape) for x in leaves) == 91_008
    assert rec["n_params_analytic"] == 90_880


def _blocks(cfg, mesh: Mesh) -> dict:
    """{name: (its `Shard`, its f32 bytes whole)} of the f32 model of `cfg`
    on `mesh` under its rules (rank 0's layout)."""
    from repro_torch.parallel.sharding import leaf_shard, make_rules

    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    rules = make_rules(mesh, model_cfg=cfg)
    return {name: (leaf_shard(name, tuple(p.shape), model.param_specs(), mesh, rules, 0),
                   4 * p.numel())
            for name, p in model.named_parameters()}


def _block_bytes(shard, nbytes: int) -> int:
    return nbytes // shard.parts // shard.mparts


def test_collective_bytes_are_the_sharded_steps_collectives(port_cells):
    """The smoke cell on 4x4 (4 data ranks, 4 model ranks), accum 2, two
    groups, untied head, f32.  Along "data", per micro-batch: the embed,
    the head and each group gathered (each group again in the remat
    recompute) whole along "data" from their blocks (sliced along "model"),
    one call a leaf, and their gradients reduce-scattered; then the gradients of the leaves
    whole along "data" with the loss all-reduced, and the norm's sum of
    squares.  Along "model", per micro-batch, all-reduces of the f32
    [2, 128, 64] activations: the lookup's sum, each group's attention
    output in the forward and in the recompute, its input's gradient and
    the MoE dispatch input's gradient in the backward, the head's input
    gradient; all-gathers of each MoE layer's expert outputs, the rank's
    [1, 1, 160, 64] of [1, 4, 160, 64] (its one dispatch group, one of 4
    experts, cap 160), in the forward and in the recompute; the cross
    entropy's row max, exponential sum and label logit ([2, 128] each);
    then the leaves a region reads whole (wk, wv, q_norm, k_norm of each
    group) and the norm's sum of squares.  (R - 1) / R of each payload,
    twice for an all-reduce."""
    rec = port_cells["4x4/train/g4"]
    cfg = groups(4)(reduced(get_config(SMOKE_ARCH), groups=2))
    blocks = _blocks(cfg, Mesh((4, 4), ("data", "model")))
    gathered = {n: nb // sh.mparts for n, (sh, nb) in blocks.items() if sh.dim is not None}
    top = gathered["embed"] + gathered["head"]
    group = sum(v for n, v in gathered.items() if n.startswith("groups."))
    accum = 2
    whole_along_data = sum(_block_bytes(sh, nb) for sh, nb in blocks.values() if sh.dim is None)
    data = {"all-gather": accum * (top + 2 * group) * 3 / 4,
            "reduce-scatter": accum * (top + group) * 3 / 4,
            "all-reduce": 2 * 3 / 4 * (whole_along_data + 4) + 2 * 3 / 4 * 4}
    act, row = 2 * 128 * cfg.d_model * 4, 2 * 128 * 4
    y = 1 * cfg.moe.n_experts * 160 * cfg.d_model * 4  # the gathered expert outputs
    summed = sum(_block_bytes(*blocks[n]) for n in blocks
                 if n.rsplit(".", 1)[-1] in ("wk", "wv", "q_norm", "k_norm"))
    assert summed == 2 * 4 * (16 * 2 * 16 * 2 + 2 * 16)  # wk, wv [16, 2, 16]; q/k_norm [16]
    model = {"all-gather": accum * cfg.n_groups * 2 * 3 / 4 * y, "reduce-scatter": 0.0,
             "all-reduce": 2 * 3 / 4 * (accum * ((1 + 4 * cfg.n_groups + 1) * act + 3 * row)
                                        + summed + 4)}
    assert rec["hlo"]["collective_by_axis"] == {"data": data, "model": model}
    by_kind = rec["hlo"]["collective_by_kind"]
    assert by_kind == {k: data[k] + model[k] for k in data}
    assert rec["hlo"]["collective_wire_bytes"] == sum(by_kind.values())
    leaves = sum(n.startswith("groups.") for n in gathered)  # one gather a leaf
    data_calls = accum * (2 + 2 * leaves) + accum * (2 + leaves) + 2
    model_calls = accum * (1 + 4 * 2 + 1 + 3 + 2 * 2) + 2
    assert rec["hlo"]["n_collective_sites"] == data_calls + model_calls
    # The decode cell (4 rows, 4 dispatch groups): along "data" the embed,
    # the head and each group gathered once; along "model" all-reduces of
    # the f32 [4, 1, 64] activations (the lookup's sum and each group's
    # attention output), all-gathers of each MoE layer's expert outputs
    # (its one group's [1, 1, 2, 64] of [1, 4, 2, 64]: cap 2) and of the
    # head's vocab slices of the f32 [4, 1, 128] logits; and each group's
    # decode attention over its quarter of the caches' sequence: an
    # all-gather of q (the rank's [4, 1, 1, 16] of [4, 1, 4, 16]: kv is
    # dropped, so no k or v), an all-reduce MAX of the score maxima [4, 2,
    # 2] and a reduce-scatter of the partial sums [4, 4] and [4, 4, 16]
    # (each rank keeps its head's): the sum of its calls.
    dec = port_cells["4x4/decode"]
    y, logits = 1 * cfg.moe.n_experts * 2 * cfg.d_model * 4, 4 * cfg.vocab * 4
    H, hd = cfg.n_heads, cfg.head_dim
    q, maxima, sums = 4 * H * hd * 4, 4 * H * 4, 4 * H * (1 + hd) * 4
    want = {"data": {"all-gather": 3 / 4 * (top + group), "reduce-scatter": 0.0,
                     "all-reduce": 0.0},
            "model": {"all-gather": 3 / 4 * (cfg.n_groups * (y + q) + logits),
                      "reduce-scatter": 3 / 4 * cfg.n_groups * sums,
                      "all-reduce": 2 * 3 / 4 * ((1 + cfg.n_groups) * 4 * cfg.d_model * 4
                                                 + cfg.n_groups * maxima)}}
    assert dec["hlo"]["collective_by_axis"] == want
    assert dec["hlo"]["collective_wire_bytes"] == sum(
        sum(v.values()) for v in want.values()) > 0
    assert dec["hlo"]["n_collective_sites"] == (2 + leaves) + (1 + 2 + 2 + 1) + 3 * cfg.n_groups


def test_port_rank_bytes_hold_the_ranks_slices(port_cells):
    """A rank of the smoke cell on 4x4 holds its block of each leaf: a
    quarter along "data" where "data" splits it, a quarter along "model"
    where "model" does (the heads, the vocab, the experts: one of 4 a
    rank), as f32 parameters, f32 moments and f32 gradient sums; the
    largest gather (a group's blocks whole along "data", or the embed's
    [32, 64] block) and the global batch.  A serving rank holds the same
    blocks and, of the caches, JAX's `cache_specs` share: its rows and its
    quarter of the sequence, every KV head."""
    rec = port_cells["4x4/train/g4"]
    parts = rec["memory"]["port_rank_parts"]
    cfg = groups(4)(reduced(get_config(SMOKE_ARCH), groups=2))
    blocks = _blocks(cfg, Mesh((4, 4), ("data", "model")))
    held = sum(_block_bytes(sh, nb) for sh, nb in blocks.values())
    assert held == 32_256  # against 93,696 on 4x1 (69,120 with the experts whole)
    assert parts["params"] == held and parts["opt"] == 2 * held  # f32 params and moments
    assert parts["grads"] == held  # the step's f32 sums of the blocks
    units = {}
    for n, (sh, nb) in blocks.items():
        if sh.dim is not None:
            unit = n.split(".")[1] if n.startswith("groups.") else n
            units[unit] = units.get(unit, 0) + nb // sh.mparts
    assert parts["gathered"] == max(units.values()) > units["embed"] == 4 * 32 * 64
    assert parts["batch"] == 2 * 16 * 128 * 8  # every rank holds the global batch
    assert rec["memory"]["port_rank_bytes"] == sum(parts.values())
    assert rec["memory"]["fits_one_card"] is True
    layout = rec["memory"]["state_layout"]
    assert layout["fsdp"] == "data" and layout["data_parts"] == 4
    assert layout["tp"] == "model" and layout["model_parts"] == 4 and layout["kv"] is None
    assert layout["ep"] == "model" and layout["ep_parts"] == 4
    assert layout["summed_over_model"] == 8
    assert layout["whole_param_bytes"] == sum(nb for sh, nb in blocks.values()
                                              if sh.dim is None and sh.mdim is None)
    dec = port_cells["4x4/decode"]
    assert dec["memory"]["port_rank_parts"]["batch"] == 4 * 8  # its 4 rows' tokens
    assert dec["memory"]["port_rank_parts"]["params"] == held  # the same blocks
    assert dec["memory"]["port_rank_parts"]["gathered"] == parts["gathered"]
    from repro_torch.parallel.sharding import make_rules

    # [G, 4 rows, S / 4 = 64 (its quarter of the sequence), both KV heads, 16]
    # f32, k and v: JAX's sanitized cache_specs share on 4x4
    cell = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    mesh = Mesh((4, 4), ("data", "model"))
    s, a = smoke()
    with s, a:
        share = dr.cache_share_bytes(cell, "decode_32k", make_rules(mesh, model_cfg=cfg), mesh)
    assert dec["memory"]["port_rank_parts"]["caches"] == share == 2 * 2 * 4 * 64 * 2 * 16 * 4
    dec_layout = dec["memory"]["state_layout"]
    assert {k: v for k, v in dec_layout.items() if k != "caches"} == layout
    assert dec_layout["caches"] == {"rows": "dp", "sequence": "model", "positions": [0, 64],
                                    "model_split": {"pos0": "sequence"}}
    pre = port_cells["4x4/prefill"]  # 2 rows, S = 64: its 16 positions
    assert pre["memory"]["port_rank_parts"]["caches"] == 2 * 2 * 2 * 16 * 2 * 16 * 4
    assert pre["memory"]["state_layout"]["caches"]["positions"] == [0, 16]


def test_a_ranks_state_bytes_are_jaxs_argument_bytes_on_a_data_only_mesh(port_cells,
                                                                         jax_cells):
    """On 4x1 the rank's parameter and moment slices (the leaves "data" does
    not divide whole) are exactly JAX's per-device argument bytes less its
    batch (int32 tokens and labels of 4 rows of 128) and its int32 step."""
    rec = port_cells["4x1/train/g4"]
    parts = rec["memory"]["port_rank_parts"]
    jax_args = jax_cells["cells"]["4x1/train/g4"]["memory"]["argument_bytes"]
    assert parts["params"] + parts["opt"] == jax_args - 4 * 2 * 4 * 128 - 4


def test_wire_bytes_equal_the_sum_of_the_collective_wrappers_calls():
    """Every collective call of a counted step, read from its arguments as it
    is made: the ring bytes of its payload over its ranks sum to the
    record's wire bytes, by kind."""
    from repro_torch.parallel import fsdp

    seen = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    by_axis: dict = {}
    calls = []
    orig = fsdp._collective

    def spy(kind, nbytes, ranks, group, t, run, axis="data"):
        if ranks > 1:
            wire = (2 if kind == "all-reduce" else 1) * (ranks - 1) / ranks * nbytes
            seen[kind] += wire
            by_axis.setdefault(axis, dict.fromkeys(seen, 0.0))[kind] += wire
            calls.append(kind)
        return orig(kind, nbytes, ranks, group, t, run, axis)

    s, a = smoke()
    with s, a, mock.patch.object(fsdp, "_collective", spy):
        rec, _ = dr.lower_cell("smoke", "train_4k", Mesh((2, 2), ("data", "model")), accum=2,
                               cfg_override=groups(4))
    assert rec["hlo"]["collective_by_kind"] == seen
    assert rec["hlo"]["collective_by_axis"] == by_axis and set(by_axis) == {"data", "model"}
    assert rec["hlo"]["collective_wire_bytes"] == sum(seen.values()) > 0
    assert rec["hlo"]["n_collective_sites"] == len(calls)


@pytest.mark.parametrize("name", ["4x4/train/g4", "4x4/decode", "4x4/prefill"])
def test_roofline_terms_are_positive_at_h100_rates(port_cells, name):
    rl = port_cells[name]["roofline"]
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["t_compute_s"] == port_cells[name]["hlo"]["dot_flops"] / 989e12
    assert rl["t_memory_s"] == port_cells[name]["hlo"]["bytes_accessed"] / 3.35e12
    assert rl["t_collective_s"] > 0  # the decode rank gathers its blocks too


def test_records_name_what_has_no_counterpart(port_cells):
    rec = port_cells["4x4/decode"]
    for key in rec["no_counterpart"]:
        part, _, field = key.partition(".")
        assert (rec[part][field] if field else rec[part]) is None
    assert rec["device"] == "meta" and "backend='ref'" in rec["counts_of"]
    assert rec["count_s"] >= 0 and rec["compile_s"] is None


def test_the_counters_read_each_input_once_write_each_output_once_and_skip_views():
    a, b = (torch.empty(4, 8, device="meta") for _ in range(2))
    w = torch.empty(8, 16, device="meta")

    def program():
        c = a + b  # reads 2 x 128 bytes, writes 128
        c.view(8, 4).t()  # views: 0
        c.add_(b)  # reads c and b, writes c
        torch.empty(1024, device="meta")  # an allocation without a fill: 0
        return c @ w  # reads 128 + 512, writes 256; 2 x 4 x 16 x 8 FLOPs

    out, flops, nbytes, secs = dr.count(program)
    assert out.device.type == "meta" and tuple(out.shape) == (4, 16)
    assert flops == 2 * 4 * 16 * 8
    assert nbytes == 3 * 128 + 3 * 128 + (128 + 512 + 256) and secs >= 0


class DeviceLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.devices |= {t.device.type for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor)}
        return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_no_tensor_of_the_dry_run_is_off_the_meta_device(shape):
    s, a = smoke()
    log = DeviceLog()
    with s, a, log:
        rec, compiled = dr.lower_cell("smoke", shape, Mesh((2, 2), ("data", "model")), accum=2,
                                      cfg_override=groups(4))
    assert rec["ok"] and compiled is None
    assert log.devices == {"meta"}
    assert not torch.cuda.is_initialized()


# --------------------------------------------------------------------------
# mesh.py, perf.py and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_meshes_equal_jaxs(jax_cells, kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    want = jax_cells["meshes"][kind]
    assert list(mesh.axis_sizes) == want["shape"] and list(mesh.axis_names) == want["axes"]
    assert mesh_label(mesh) == want["label"]


def test_perf_variants_equal_jaxs(jax_cells):
    assert {k: d for k, (_, d) in perf.VARIANTS.items()} == jax_cells["variants"]
    assert list(perf.VARIANTS) == list(jax_cells["variants"])


def test_perf_run_tells_the_dispatch_variants_apart(tmp_path):
    s, a = smoke()
    out = tmp_path / "perf.json"
    with s, a, mock.patch.dict(perf.CELLS, {"S": ("smoke", "train_4k")}):
        base = perf.run("S", "baseline", out=str(out))
        sort = perf.run("S", "sort_dispatch", out=str(out))
    assert base["ok"] and sort["ok"]
    assert base["desc"] == "baseline (scatter MoE, accum=4)"
    assert base != sort and base["t_memory_s"] != sort["t_memory_s"]
    assert base["temp_gb"] is None and "temp_gb" in base["no_counterpart"]
    assert [e["variant"] for e in json.loads(out.read_text())] == ["baseline", "sort_dispatch"]


def test_cli_writes_every_cell_of_an_arch(tmp_path, capsys):
    s, a = smoke()
    out = tmp_path / "dryrun_torch.json"
    argv = ["--arch", "smoke", "--shape", "train_4k,decode_32k", "--mesh", "single",
            "--out", str(out)]
    with s, a:
        # the decode cell's 16 rows over 16 data ranks make the smoke config's 2 MoE
        # dispatch groups, each on a span of 8 ranks that gather their choices
        dr.main(argv)
        dr.main(argv)  # the second run resumes: both cells are cached
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["mesh"], r["ok"]) for r in recs] == [
        ("train_4k", "16x16", True), ("decode_32k", "16x16", True)]
    assert recs[1]["rank"]["data_shards"] == 16 and recs[1]["rank"]["rows"] == 1
    assert recs[1]["hlo"]["collective_by_site"]["moe-choices"]["calls"] == 2
    # B = 16 rows over 16 data ranks at accum 4: every rank takes all 4 rows of a micro-batch;
    # the 16 ranks along "data" repeat the program, the 16 along "model" split its vocab
    assert recs[0]["rank"] == {"rank": 0, "rows": 4, "data_shards": 1, "repetition": 16}
    assert "skip ('smoke', 'train_4k', '16x16') (cached)" in capsys.readouterr().out
