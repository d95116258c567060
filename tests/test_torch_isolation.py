"""The port stands alone: no JAX and nothing of the `repro` package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch.api, repro_torch.interop\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


# Modules that exist only to raise ImportError on import, naming where their
# contents live (as the JAX package's `repro.serving.engine` does): module ->
# a phrase of the message.
STUB_MODULES = {
    "repro_torch.serving.engine": "import ServeEngine and SamplerConfig from repro_torch.serving",
}
ALL_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")
)
PORT_MODULES = [m for m in ALL_MODULES if m not in STUB_MODULES]


@pytest.fixture(scope="module")
def fresh_imports():
    """Import each module of the port first thing in an interpreter of its
    own (an import cycle shows only for some entry modules), four at a time.
    Maps each module to (return code, stderr)."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(module):
        out = subprocess.run([sys.executable, "-c", f"import {module}"], capture_output=True,
                             text=True, env=env, timeout=300)
        return out.returncode, out.stderr[-2000:]

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(ALL_MODULES, pool.map(run, ALL_MODULES)))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_each_port_module_imports_first_in_a_fresh_interpreter(module, fresh_imports):
    rc, err = fresh_imports[module]
    assert rc == 0, f"import {module} in a fresh interpreter failed:\n{err}"


@pytest.mark.parametrize("module", sorted(STUB_MODULES))
def test_stub_module_raises_import_error_naming_the_new_home(module, fresh_imports):
    rc, err = fresh_imports[module]
    assert rc != 0 and "ImportError" in err and STUB_MODULES[module] in err, err
