"""Run manifests — a copy of ``repro/obs/manifest.py`` whose
:func:`mesh_info` reads torch's devices instead of JAX's.

Every JSONL/trace directory gets a ``manifest.json`` recording enough
to reproduce and attribute the run: a stable hash of the run config,
the git SHA, the devices (count/kinds/backend), platform, and the
caller's extras (arch, mode, CLI argv). Written at run *start* so even
a crashed run is attributable. The keys are the reference's, so that
one tool reads both packages' manifests, and :func:`config_hash` gives
the reference's hash for an equal config.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

import torch


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def config_hash(config: Any) -> str:
    """Stable sha256 over the JSON form of a config (dataclasses,
    dicts, and nests thereof)."""
    blob = json.dumps(_jsonable(config), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_sha(cwd: Optional[str] = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def mesh_info() -> dict:
    """``{"backend": "cuda"|"cpu", "device_count", "device_kinds"}``:
    the CUDA devices where there are any, else the host."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return {"backend": "cuda", "device_count": n,
                "device_kinds": sorted({torch.cuda.get_device_name(i)
                                        for i in range(n)})}
    return {"backend": "cpu", "device_count": 1, "device_kinds": ["cpu"]}


def write_manifest(out_dir: str, config: Any = None,
                   extra: Optional[dict] = None) -> str:
    """Write ``out_dir/manifest.json``; returns its path."""
    doc = {
        "unix_ts": int(time.time()),
        "config_hash": config_hash(config) if config is not None else None,
        "config": _jsonable(config) if config is not None else None,
        "git_sha": git_sha(),
        "mesh": mesh_info(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
    }
    if extra:
        doc.update(_jsonable(extra))
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    path = p / "manifest.json"
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return str(path)


__all__ = ["config_hash", "git_sha", "mesh_info", "write_manifest"]
