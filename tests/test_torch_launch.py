"""The port's entry points: the launcher on the CPU, its refusal to
silently leave the GPU, chip_smoke.py's refusal to run without one, and
the port's independence from JAX and from the JAX package."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _run(args, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_launcher_runs_on_cpu_when_asked():
    p = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--rounds", "2", "--n-train", "400", "--algorithm", "async_ama",
              "--p-delay", "0.3", "--max-delay", "2", "--eval-every", "1"])
    assert p.returncode == 0, p.stderr
    assert "final: acc=" in p.stdout and "stability_var=" in p.stdout
    assert "AsyncAMAStrategy" in p.stdout


@pytest.mark.parametrize("argv,strategy", [
    (["--algorithm", "fedopt"], "FedOptStrategy"),
    (["--comm-plane", "q8", "--env", "bandwidth", "--max-delay", "5"],
     "AsyncAMAStrategy")])
def test_launcher_runs_this_slice_on_cpu(argv, strategy):
    p = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--rounds", "2", "--n-train", "400", *argv])
    assert p.returncode == 0, p.stderr
    assert "final: acc=" in p.stdout and strategy in p.stdout


def test_launcher_runs_the_legacy_plane_with_checkpoint_and_telemetry(
        tmp_path):
    """Slice 3's flags on the CPU: the legacy chain on the ama_mix
    kernel's entry point, --metrics-out, --checkpoint, then --resume,
    and the report CLI over the JSONL."""
    ck, run = str(tmp_path / "ck.npz"), str(tmp_path / "run.jsonl")
    base = ["-m", "repro_torch.launch.train", "--device", "cpu",
            "--n-train", "400", "--rounds", "2", "--algorithm", "async_ama",
            "--p-delay", "0.3", "--max-delay", "2", "--server-plane",
            "legacy", "--use-kernel", "--prefetch-depth", "2"]
    p = _run([*base, "--metrics-out", run, "--checkpoint", ck])
    assert p.returncode == 0, p.stderr
    assert "server plane legacy (ama_mix kernel)" in p.stdout
    assert "phases: stage=" in p.stdout and "saved " + ck in p.stdout
    p = _run([*base, "--resume", ck, "--client-reduce", "force"])
    assert p.returncode == 0, p.stderr
    assert f"resumed {ck} at round 2" in p.stdout
    p = _run(["-m", "repro_torch.obs.report", run])
    assert p.returncode == 0, p.stderr
    assert "run: algorithm=async_ama" in p.stdout
    p = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--server-plane", "interpret"])
    assert p.returncode == 2 and "Pallas interpreter" in p.stderr


def test_launcher_and_smoke_refuse_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run(["-m", "repro_torch.launch.train", "--rounds", "2",
              "--algorithm", "fedopt", "--comm-plane", "q8"])
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr and "--device cpu" in p.stderr
    p = _run([str(REPO / "chip_smoke.py")])
    assert p.returncode != 0 and '"ok"' not in p.stdout
    assert "torch.cuda.is_available() is false" in p.stderr
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    p = _run([str(alone)], cwd=tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout


def test_port_imports_nothing_of_jax_or_the_jax_package():
    code = """
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) > 30, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    env = {k: v for k, v in ENV.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, str(REPO / "src")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert "BAD []" in p.stdout, p.stdout


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """The same independence read off the sources: no import statement
    of src/repro_torch or chip_smoke.py names jax, jaxlib or repro."""
    bad_import = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 40
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in bad_import.finditer(f.read_text())]
    assert hits == []
