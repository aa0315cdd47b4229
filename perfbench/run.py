"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from a profiled
window by the readers in ``perfbench/metrics/``. Either way the run
holds what the window's entry produced to the plain reference and says
so in ``correct``; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of the result. The run
needs a CUDA device: without one (or with fewer than the cell asks for)
it exits with code 2 and prints no result. It exits with code 3, and no
result, if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build" / "perfbench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch"
                                              / "build")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"

    from perfbench import harness
    from perfbench.drivers.common import Run
    cell = harness.Cell.load(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.config['kind']}.py",
        f"perfbench_driver_{cell.config['kind']}")
    out = driver.run(Run(cell=cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device=device,
                         t_start=T_START))

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            reader = harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py",
                f"perfbench_metric_{m['name'].replace('.', '_')}")
            v = reader.read(out.facts, out.trace, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": out.peak_bytes,
           "power_limit": power_limit()}
    if args.trace:
        dev.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)

    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    result = {"correct": harness.passed(out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = out.checks
    sys.stdout.flush()
    for k, c in out.checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
