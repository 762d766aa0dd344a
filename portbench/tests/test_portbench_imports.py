"""No run of the benchmark loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level names, and the reference imports nothing of
the port."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import guard

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"


def test_names_compare_whole():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "reprolib"]) == set()
    assert guard.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                    "flax.linen"]) == {"repro", "jax",
                                                       "jaxlib", "flax"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin",
             "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    loaded = _loaded_after(
        "from portbench import harness, spec, guard, trace, faults\n"
        "from portbench.tools import calibrate")
    assert "repro_torch" in loaded
    assert not guard.forbidden_modules(loaded)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.rounds")
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & loaded


def test_reference_sources_import_only_torch():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in ("__future__", "torch", "portbench"), (path, n)
                assert not n.startswith("portbench.") or \
                    n.startswith("portbench.reference"), (path, n)
