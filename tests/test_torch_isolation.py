"""The PyTorch port stands alone: no file of ``src/repro_torch/`` (nor
``chip_smoke.py``, nor the ``examples/torch_*.py`` twins) imports ``jax``
or the reference package ``repro``, every module imports and the twins
run with both blocked, and the entry points refuse to
run quietly on the CPU (no GPU and no explicit ``device="cpu"`` raises;
``chip_smoke.py`` exits non-zero without a card or without the repo)."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_repro():
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(twins) == 3
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + twins
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.core import TTHFTrainer
from repro_torch.data import fashion_synth, partition_noniid_labels
from repro_torch.models import make_sim_model
x, y = fashion_synth(num_points=400, seed=0)
data = partition_noniid_labels(x, y, num_devices=4)
tr = TTHFTrainer(make_sim_model("svm", 784, 10), data,
                 TopologyConfig(num_devices=4, num_clusters=2, graph="ring"),
                 TTHFConfig(tau=2, consensus_every=1), batch_size=4,
                 use_kernel=True, device="cpu")
_, hist = tr.run(steps=2, eval_every=1)
assert len(hist.global_loss) == 2
for new in ("repro_torch.core.distributed", "repro_torch.train.trainer",
            "repro_torch.models.transformer", "repro_torch.data.tokens",
            "repro_torch.kernels.fused_consensus_sgd",
            "repro_torch.kernels.fused_sgd",
            "repro_torch.kernels.paged_decode",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
            "repro_torch.serving", "repro_torch.serving.engine",
            "repro_torch.serving.scheduler", "repro_torch.serving.pages",
            "repro_torch.launch.serve", "repro_torch.core.theory",
            "repro_torch.netsim", "repro_torch.netsim.dynamics",
            "repro_torch.netsim.events", "repro_torch.netsim.faults",
            "repro_torch.netsim.scenarios", "repro_torch.hierarchy",
            "repro_torch.hierarchy.tree", "repro_torch.hierarchy.presets",
            "repro_torch.hierarchy.aggregate", "repro_torch.control",
            "repro_torch.control.laws", "repro_torch.control.estimator",
            "repro_torch.control.policies",
            "repro_torch.control.controller", "repro_torch.obs",
            "repro_torch.obs.sink", "repro_torch.obs.trace",
            "repro_torch.obs.manifest", "repro_torch.obs.telemetry",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.optim.optimizers", "repro_torch.launch.steps",
            "repro_torch.launch.cost", "repro_torch.launch.analysis",
            "repro_torch.launch.dryrun"):
    assert new in names, new
from repro_torch.netsim import scenarios
tr = TTHFTrainer(make_sim_model("svm", 784, 10), data,
                 TopologyConfig(num_devices=4, num_clusters=2, graph="ring"),
                 TTHFConfig(tau=2, consensus_every=1), batch_size=4,
                 use_kernel=True, dynamics=scenarios.get("device_churn"),
                 device="cpu")
_, hist = tr.run(steps=4, eval_every=2)
assert len(hist.active_devices) == 2
from repro_torch.control import get_policy
from repro_torch.hierarchy import presets
from repro_torch.rounds import RoundProgram
for prog in (RoundProgram(hierarchy=presets.get("fog3", tau=2),
                          dynamics=scenarios.get("device_churn")),
             RoundProgram(control=get_policy("connectivity"))):
    x8, y8 = fashion_synth(num_points=400, seed=0)
    tr = TTHFTrainer(make_sim_model("svm", 784, 10),
                     partition_noniid_labels(x8, y8, num_devices=8),
                     TopologyConfig(num_devices=8, num_clusters=4,
                                    graph="ring"),
                     TTHFConfig(tau=2, consensus_every=1), batch_size=4,
                     use_kernel=True, program=prog, device="cpu")
    _, hist = tr.run(steps=4, eval_every=2)
    assert len(hist.global_loss) == 2 and tr.ledger.uplinks > 0
import runpy
for twin, argv in (
        ("torch_quickstart", ["--steps", "2", "--devices", "10",
                              "--clusters", "2", "--points", "400"]),
        ("torch_federated_image_classification", ["--fast", "--steps", "2"]),
        ("torch_tthf_lm_pretrain", ["--dim", "64", "--layers", "1",
                                    "--d-ff", "64", "--vocab", "64",
                                    "--seq", "8", "--batch", "1",
                                    "--tau", "2", "--intervals", "1"])):
    sys.argv = [twin] + argv + ["--device", "cpu"]
    runpy.run_path(f"{EXAMPLES}/{twin}.py", run_name="__main__")
from repro_torch.configs import get_arch
from repro_torch.core.distributed import TTHFScaleConfig
from repro_torch.train import ScaleTrainer, TrainerConfig
st = ScaleTrainer(get_arch("qwen1.5-0.5b").reduced(d_model=64, vocab_size=64),
                  TTHFScaleConfig(replicas=4, cluster_size=2, tau=2,
                                  consensus_every=1),
                  TrainerConfig(batch_per_replica=1, seq_len=8, intervals=1,
                                eval_every=0, fused_interval=True),
                  device="cpu").run()
assert st.interval == 1 and st.ledger.uplinks == 2
st = ScaleTrainer(get_arch("qwen1.5-0.5b").reduced(d_model=64, vocab_size=64),
                  TTHFScaleConfig(replicas=4, cluster_size=2, tau=2,
                                  consensus_every=1),
                  TrainerConfig(batch_per_replica=1, seq_len=8, intervals=2,
                                eval_every=0, fused_interval=True),
                  program=RoundProgram(hierarchy=presets.get("fog3", tau=2),
                                       dynamics=scenarios.get("device_churn")),
                  device="cpu").run()
assert st.interval == 2 and st.ledger.uplinks_by_level[2] > 0
import torch
from repro_torch.models import build_model
from repro_torch.serving import PagedContinuousScheduler, Request
cfg = get_arch("qwen1.5-0.5b").reduced(d_model=64, vocab_size=64)
model = build_model(cfg)
sched = PagedContinuousScheduler(model, slots=2, max_prompt=8, max_total=12,
                                 page_size=4, device="cpu")
sched.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=3))
params = model.init(torch.Generator().manual_seed(0), "cpu")
sched.step(params)
assert sched.stats.decode_steps == 1 and sched.paged_kernel is False
ssm_model = build_model(get_arch("mamba2-370m").reduced(d_model=64,
                                                        vocab_size=64))
ssm_sched = PagedContinuousScheduler(ssm_model, slots=2, max_prompt=8,
                                     max_total=12, page_size=4,
                                     prefill_chunk=4, device="cpu")
ssm_sched.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=3))
ssm_params = ssm_model.init(torch.Generator().manual_seed(0), "cpu")
for _ in range(2):        # two prefill chunks, then a decode step
    ssm_sched.step(ssm_params)
assert ssm_sched.stats.decode_steps == 1 and ssm_sched.ssd_kernel is False
# the dry run's imports sit inside its functions: run one, sizes only, on
# a fake process group, and the optimizers and step builders it reaches
from repro_torch.launch import dryrun
rec = dryrun.run_serve_one("qwen1.5-0.5b", "pod", slots=16, max_prompt=32,
                           max_total=64, paged=True, page_size=16,
                           verbose=False)
assert rec["status"] == "ok" and rec["flops_dev"] > 0
rec = dryrun.run_serve_one("mamba2-370m", "pod", slots=16, max_prompt=64,
                           max_total=128, verbose=False)
assert rec["status"] == "ok"
assert "ssd_scan" in rec["programs"]["admission"]["coll_breakdown"]["kernels"]
rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", "pod", verbose=False)
assert rec["status"] == "ok" and rec["flops_dev"] > 0
import torch.distributed
torch.distributed.destroy_process_group()
print(len(names))
"""


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = f"EXAMPLES = {str(ROOT / 'examples')!r}\n" + _BLOCKED_IMPORT
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_profiler_failure_is_not_swallowed(monkeypatch, tmp_path):
    """The reference swallows ``jax.profiler`` errors; the port's sink
    lets a profiler that cannot start fail the run."""
    from repro_torch.obs.sink import make_obs

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        make_obs(str(tmp_path / "obs"), profile=True)
    assert make_obs(None, profile=True).enabled is False


def test_resolve_device_raises_without_a_card(monkeypatch):
    from repro_torch.kernels.runtime import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [ROOT, tmp_path]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for where in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small"])
def test_chip_smoke_direct_comparison_runs_on_the_cpu(arch, capsys):
    """The reduced comparison of chip_smoke.py's [vlm] and [audio] phases
    (a direct run on the card against the same run on the CPU) runs here
    with the CPU standing in for the card, and passes its own check."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    chip_smoke.direct_card_vs_cpu("test", arch, card="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[test] reduced {arch} direct run") and \
        "the same greedy tokens" in line
