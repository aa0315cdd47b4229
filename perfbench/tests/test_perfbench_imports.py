"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level module name (``repro_torch`` is the port),
and the reference imports nothing of the program."""
import ast
import subprocess
import sys

from perfbench import harness

PKG = harness.HERE


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not imported(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        assert "repro_torch" not in imported(path), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.split(".")[:2] != ["perfbench",
                                                      "drivers"], path


def test_a_run_loads_no_jax():
    """Every module of the benchmark, and a tiny cell driven through
    set-up, window and reference, in a fresh process."""
    code = f"""
import sys, time
sys.path[0:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r},
                 {str(PKG / 'tests')!r}]
import torch
from perfbench import harness
from perfbench.drivers.common import Run
from conftest import tiny_sim
for sub in ("drivers", "metrics", "counts", "reference", "models"):
    for p in (harness.HERE / sub).glob("*.py"):
        harness.load_module(p, "m_" + sub + "_" + p.stem.replace(".", "_"))
import perfbench.calibrate, perfbench.run
from perfbench.drivers import sim
out = sim.run(Run(cell=tiny_sim("static", "sim.nn7840.static"), seed=3,
                  seconds=0.1, trace=False, device=torch.device("cpu"),
                  t_start=time.perf_counter()))
assert harness.passed(out.checks), out.checks
print("LOADED", harness.forbidden_loaded())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-2000:]


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device (forced here): exit 2 and no result line."""
    res = subprocess.run(
        [sys.executable, str(PKG / "run.py"), "--workload",
         "sim.nn7840.static", "--seed", str(2**31 + 11), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert res.returncode == 2, res.stderr[-2000:]
    assert res.stdout.strip() == ""
