"""The dry run's TT-HF interval programs (``repro_torch.launch.dryrun.
build_tthf_program``, ``--sync``) on meshes:

* on 4 gloo ranks (a (2, 2) ``("data", "model")`` mesh, 2 replicas in one
  cluster, and a (2, 2) ``("pod", "data")`` mesh, 4 replicas in 2
  clusters, rows moved over both axes; each rank holding its replicas'
  rows): one interval of every sync (``tthf-fused-interval``,
  ``tthf-fused``, ``tthf-rounds``, ``star``, ``local``) on a reduced
  qwen equals the unsharded step
  (``make_tthf_train_step`` on the whole replica buffer) — params and
  loss to 1e-6 — in a subprocess of this file under a hard timeout;
* sizes only on the fake pod and multi-pod meshes (16 replicas in one
  cluster; 32 in two): every sync traces to an "ok" record, the fused
  interval charges ``fused_consensus_sgd`` once a block, and the
  cross-replica ops are all-to-alls over the replica axes (rows to
  columns and back; none for ``local``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SYNCS = ("tthf-fused-interval", "tthf-fused", "tthf-rounds", "star",
         "local")
T, GLOBAL_B, TAU = 16, 4, 2


def _cfg():
    from repro_torch.configs import get_arch
    return get_arch("qwen1.5-0.5b").reduced(d_model=64, d_ff=128,
                                            vocab_size=128)


def _program(sync, mesh):
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    model = build_model(_cfg())
    return model, dryrun.build_tthf_program(
        model, InputShape("train_4k", T, GLOBAL_B, "train"), mesh,
        "tthf" if sync.startswith("tthf") else sync,
        "fused" if "fused" in sync else "rounds", tau=TAU,
        consensus_every=1, fused_interval=sync == "tthf-fused-interval")


def _group(out: str) -> None:
    """Every sync on a (2, 2) gloo mesh; rank 0 saves the gathered
    results and the unsharded step's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    res = {}
    for names in (("data", "model"), ("pod", "data")):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
        _syncs(mesh, "x".join(names), res)
    if dist.get_rank() == 0:
        np.savez(out, **res)


def _syncs(mesh, tag: str, res: dict) -> None:
    import torch.distributed as dist
    from repro_torch.core.distributed import (
        FlatParamSpec, TTHFScaleConfig, make_tthf_train_step,
        stack_replicas)
    from repro_torch.models.common import tree_items
    for sync in SYNCS:
        model, (fn, args) = _program(sync, mesh)
        R = args[0].shape[0] if torch.is_tensor(args[0]) else \
            tree_items(args[0])[0][1].shape[0]
        params = stack_replicas(model.init(torch.Generator().manual_seed(0),
                                           "cpu"), R)
        fused = sync == "tthf-fused-interval"
        spec = FlatParamSpec.for_model(model)
        start = spec.flatten(params) if fused else params
        rng = np.random.default_rng(1)
        tb = torch.from_numpy(rng.integers(
            0, 128, size=tuple(args[1]["tokens"].shape)).astype(np.int32))
        batch = {"tokens": tb, "labels": tb.roll(1, dims=-1)}
        picks = torch.zeros(tuple(args[2].shape), dtype=torch.int32)
        idx = torch.zeros((), dtype=torch.int32)
        got, loss = fn(start.clone() if fused else
                       {k: v for k, v in start.items()}, batch, picks, idx)
        got = (got.full_tensor() if fused else
               {p: v.full_tensor() for p, v in tree_items(got)})
        if dist.get_rank() == 0:
            cluster = 2 if "pod" in tag else R
            scale = TTHFScaleConfig(replicas=R, cluster_size=cluster,
                                    tau=TAU,
                                    consensus_every=1, gamma_d2d=2,
                                    consensus_mode="fused" if "fused" in sync
                                    else "rounds", lr=1e-2, graph="ring")
            step, _ = make_tthf_train_step(
                model, scale, dtype=torch.bfloat16,
                sync="tthf" if sync.startswith("tthf") else sync,
                fused_interval=fused, device="cpu")
            base = spec.flatten(params) if fused else stack_replicas(
                model.init(torch.Generator().manual_seed(0), "cpu"), R)
            want, wloss = step(base, batch, picks)
            want = want if fused else dict(tree_items(want))
            key = f"{tag}/{sync}"
            if fused:
                res[f"{key}/got"] = got.numpy()
                res[f"{key}/want"] = want.numpy()
            else:
                for p, v in got.items():
                    res[f"{key}/got/{'/'.join(p)}"] = v.numpy()
                    res[f"{key}/want/{'/'.join(p)}"] = want[p].numpy()
            res[f"{key}/loss"] = np.asarray([float(loss.full_tensor()),
                                             float(wloss)])


def test_every_sync_on_four_gloo_ranks_equals_the_unsharded_step(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), str(ROOT / "tests"),
                os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, str(Path(__file__)),
                           str(tmp_path / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = dict(np.load(tmp_path / "out.npz"))
    for tag in ("dataxmodel", "podxdata"):
        for sync in SYNCS:
            key = f"{tag}/{sync}"
            got = sorted(k for k in res if k.startswith(f"{key}/got"))
            assert got, key
            for k in got:
                np.testing.assert_allclose(
                    res[k], res[k.replace("/got", "/want", 1)], atol=1e-6,
                    rtol=0, err_msg=k)
            a, b = res[f"{key}/loss"]
            assert abs(a - b) <= 1e-6 * abs(b), (key, a, b)


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_every_sync_traces_on_the_production_mesh(mesh_name):
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    R = 16 * dryrun.MESH_PODS.get(mesh_name, 1)
    try:
        mesh = dryrun.production_mesh(mesh_name)
        for sync in SYNCS:
            _, (fn, args) = _program(sync, mesh)
            rec, _, _ = dryrun.trace(fn, args)
            assert rec.flops > 0 and rec.bytes > 0, sync
            # the replica's params gathered over model; every sync but
            # local moves rows to columns and back over the replica axes
            assert rec.coll_counts["all-gather"] > 0, sync
            moved = rec.coll_counts.get("all-to-all", 0)
            assert (moved == 0) == (sync == "local"), (sync, moved)
            assert (rec.coll_bytes.get("all-to-all", 0) > 0) == (moved > 0)
            if sync == "tthf-fused-interval":
                assert tuple(args[0].shape)[0] == R
                assert rec.kernels["fused_consensus_sgd"]["calls"] == TAU
            else:
                assert "fused_consensus_sgd" not in rec.kernels
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    from repro_torch.launch import serve as serve_cli
    serve_cli.run_on_host_devices(4, _group, sys.argv[1])
