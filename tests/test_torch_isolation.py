"""The PyTorch port stands alone: no file of ``src/repro_torch/`` (nor
``chip_smoke.py``) imports ``jax`` or the reference package ``repro``,
every module imports with both blocked, and the entry points refuse to
run quietly on the CPU (no GPU and no explicit ``device="cpu"`` raises;
``chip_smoke.py`` exits non-zero without a card or without the repo)."""
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
            "repro_torch.launch.serve"):
    assert new in names, new
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
print(len(names))
"""


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


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
