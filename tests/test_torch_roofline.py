"""The port's roofline model (`repro_torch.analysis.roofline`) against the
JAX package's.

The cases of tests/test_roofline.py run again with the port's module in
place of the JAX package's and its default chip, the H100 (`H100_SXM`), in
place of `TPU_V5E`; the H100's constants are the ones `chip_smoke.py` bounds
its kernels with.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import types
from pathlib import Path

import pytest

# The packages' `analysis` exports a function `roofline`, which shadows the
# submodule of that name as an attribute.
jroof = importlib.import_module("repro.analysis.roofline")
troof = importlib.import_module("repro_torch.analysis.roofline")

ROOT = Path(__file__).resolve().parents[1]


def _ported_cases():
    """The test methods of tests/test_roofline.py, compiled with
    `repro.analysis.roofline` read as the port's module and `TPU_V5E` as
    `H100_SXM` (the port's default chip): [(id, method name, class)]."""
    path = ROOT / "tests" / "test_roofline.py"
    src = (path.read_text().replace("repro.analysis.roofline", "repro_torch.analysis.roofline")
           .replace("TPU_V5E", "H100_SXM"))
    mod = types.ModuleType("ported_test_roofline")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    cases = []
    for node in ast.parse(src).body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name.startswith("test"):
                    cases.append((f"{node.name}::{item.name}", item.name,
                                  getattr(mod, node.name)))
    return cases


PORTED = _ported_cases()


def test_the_ported_cases_are_the_nine_of_the_jax_file():
    assert len(PORTED) == 9


@pytest.mark.parametrize("name,cls", [(n, c) for _, n, c in PORTED],
                         ids=[i for i, _, _ in PORTED])
def test_jax_packages_roofline_cases_hold_for_the_port(name, cls, tmp_path):
    method = getattr(cls(), name)
    if "tmp_path" in method.__code__.co_varnames[:method.__code__.co_argcount]:
        method(tmp_path)
    else:
        method()


def test_h100_constants_are_chip_smokes():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines the phases; runs none of them
    h = troof.H100_SXM
    assert (smoke.HBM_BYTES_PER_S, smoke.FP32_FLOPS, smoke.BF16_FLOPS) == (
        h.hbm_bw, h.f32_flops, h.peak_flops)
    assert (h.peak_flops, h.f32_flops, h.hbm_bw, h.ici_bw, h.hbm_per_chip) == (
        989e12, 67e12, 3.35e12, 450e9, 80e9)


def test_default_hardware_is_the_h100_and_tpu_v5e_is_the_references():
    r = troof.roofline(arch="a", shape="s", mesh="m", hlo_flops=1.0, hlo_bytes=1.0,
                       collective_bytes=1.0, model_flops=1.0)
    assert r.hw == troof.H100_SXM
    ref = dataclasses.asdict(jroof.TPU_V5E)
    port = dataclasses.asdict(troof.TPU_V5E)
    assert {k: port[k] for k in ref} == ref


def test_rows_and_table_match_jax_on_the_same_hardware():
    kw = dict(arch="a", shape="s", mesh="m", hlo_flops=3e14, hlo_bytes=2e11,
              collective_bytes=5e9, model_flops=2e14, extras={"x": 1.5})
    t = troof.roofline(hw=troof.TPU_V5E, **kw)
    j = jroof.roofline(hw=jroof.TPU_V5E, **kw)
    assert t.row() == j.row()
    assert troof.format_table([t.row()]) == jroof.format_table([j.row()])
