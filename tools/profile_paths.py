#!/usr/bin/env python3
"""Where the time of the sim path under netsim weather and of the ssm
scale path goes, by ``torch.profiler`` (CUDA activity only).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/profile_paths.py

After a warm-up of each, it profiles, at ``chip_smoke.py``'s sizes:

- ``sim``: 20 steps of the paper-size NN sim (125 devices in 25
  clusters, hidden width 7840) on the static topology, consensus through
  ``consensus_mix``;
- ``sim-churn``: the same 20 steps under the ``device_churn`` scenario
  (a dark device's rows of the update zeroed, each event's V from the
  active subgraph, the weighted aggregation);
- ``scale-ssm``: one fused interval of ``ScaleTrainer`` on the full
  mamba2-370m with the scale CLI's defaults (4 replicas, batch 16 x seq
  128, τ 20, consensus every 5, Γ 2).

For each it prints the wall time, the device's busy time and idle share,
and the 15 kernels with the most device time. The card's name and power
limit come first.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def profile_sim(scenario) -> None:
    import torch
    from repro_torch.core import TTHFTrainer
    from repro_torch.netsim import scenarios

    data, topo, nn, _ = cs.sim_setup()
    dyn = scenarios.get(scenario, seed=0) if scenario else None

    def run(steps):
        tr = TTHFTrainer(nn, data, topo, cs.sim_algo(), batch_size=16,
                         use_kernel=True, dynamics=dyn)
        torch.cuda.synchronize()
        t0 = cs.time.time()
        tr.run(steps=steps, seed=0, eval_every=10)
        torch.cuda.synchronize()
        return cs.time.time() - t0

    cs.log(f"[profile-paths] warm-up: 5 steps in {run(5):.3f} s")
    cs.profile_main_path(lambda: run(20),
                         f"20 sim steps ({scenario or 'static'})")


def profile_scale_ssm() -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("mamba2-370m")
    scale = cs.scale_cli_config()
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    wall = cs.scale_run(cfg, scale, True, 1, "profile_ssm_warmup",
                        weights=w0)[2]
    cs.log(f"[profile-paths] warm-up: 1 interval in {wall:.3f} s")
    torch.cuda.empty_cache()
    cs.profile_main_path(
        lambda: cs.scale_run(cfg, scale, True, 1, "profile_ssm",
                             weights=w0)[2],
        "1 mamba2-370m scale interval (fused)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    profile_sim(None)
    profile_sim("device_churn")
    torch.cuda.empty_cache()
    profile_scale_ssm()
    return 0


if __name__ == "__main__":
    sys.exit(main())
