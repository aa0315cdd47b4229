#!/usr/bin/env python3
"""Where the time of the sim path under netsim weather and the control
plane, of the ssm scale path and of the scale forms goes, by
``torch.profiler`` (CUDA activity only).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/profile_paths.py [--paths sim,sim-churn,...]

After a warm-up of each, it profiles, at ``chip_smoke.py``'s sizes:

- ``sim``: 20 steps of the paper-size NN sim (125 devices in 25
  clusters, hidden width 7840) on the static topology, consensus through
  ``consensus_mix``;
- ``sim-churn``: the same 20 steps under the ``device_churn`` scenario
  (a dark device's rows of the update zeroed, each event's V from the
  active subgraph, the weighted aggregation);
- ``scale-ssm``: one fused interval of ``ScaleTrainer`` on the full
  mamba2-370m with the scale CLI's defaults (4 replicas, batch 16 x seq
  128, τ 20, consensus every 5, Γ 2);
- ``sim-control``: 20 steps of the paper-size NN sim under the
  ``connectivity`` policy and ``device_churn`` (Γ from the controller at
  each event, the gradient probe at the aggregation at 20);
- ``scale-forms``: one fused interval of ``ScaleTrainer`` on the full
  qwen1.5-0.5b at 8 replicas under ``fog3`` and ``device_churn``
  (``chip_smoke.py``'s ``[scale-forms]`` (a): the refreshed W, the
  matrix form, a root event at every second interval).

For each it prints the wall time, the device's busy time and idle share,
the host-to-device and device-to-host copies, and the 15 kernels with
the most device time. The card's name and power limit come first.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def profile_sim(scenario, policy=None) -> None:
    from repro_torch.control import get_policy
    from repro_torch.netsim import scenarios
    from repro_torch.rounds import RoundProgram

    program = RoundProgram(
        dynamics=scenarios.get(scenario, seed=0) if scenario else None,
        control=get_policy(policy) if policy else None)

    setup = cs.sim_setup()

    def run(steps):
        return cs.sim_program_run(setup, program, steps, use_kernel=True)[3]

    cs.log(f"[profile-paths] warm-up: 5 steps in {run(5):.3f} s")
    cs.profile_main_path(
        lambda: run(20), f"20 sim steps ({scenario or 'static'}"
        f"{', ' + policy if policy else ''})")


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


def profile_scale_forms() -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("qwen1.5-0.5b")
    scale = cs.scale_forms_config()
    program = cs.scale_forms_programs()["fog3-churn"]
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    wall = cs.scale_run(cfg, scale, True, 1, "profile_forms_warmup",
                        weights=w0, program=program)[2]
    cs.log(f"[profile-paths] warm-up: 1 interval in {wall:.3f} s")
    torch.cuda.empty_cache()
    cs.profile_main_path(
        lambda: cs.scale_run(cfg, scale, True, 1, "profile_forms",
                             weights=w0, program=program)[2],
        "1 qwen1.5-0.5b scale interval at 8 replicas (fused, fog3 under "
        "device_churn)")


PATHS = {
    "sim": lambda: profile_sim(None),
    "sim-churn": lambda: profile_sim("device_churn"),
    "scale-ssm": profile_scale_ssm,
    "sim-control": lambda: profile_sim("device_churn", "connectivity"),
    "scale-forms": profile_scale_forms,
}


def main() -> int:
    import torch
    paths = list(PATHS)
    if "--paths" in sys.argv[1:]:
        paths = sys.argv[sys.argv.index("--paths") + 1].split(",")
        bad = sorted(set(paths) - set(PATHS))
        if bad:
            raise SystemExit(f"unknown paths {bad}; choose from "
                             f"{sorted(PATHS)}")
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    for name in paths:
        PATHS[name]()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
