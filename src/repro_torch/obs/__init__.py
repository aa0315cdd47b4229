"""repro_torch.obs — two-timescale observability, the port of
``repro/obs/``.

Three pieces, one run directory:

* :mod:`~repro_torch.obs.trace` — a span tracer whose hierarchy mirrors
  the paper's timescales (``run > round > {interval, consensus_event,
  aggregation}`` for training; ``run > {prefill, decode_step,
  admission}`` for serving), exported as zero-dep Chrome-trace JSON,
  with ``torch.profiler`` annotations when profiling.
* :mod:`~repro_torch.obs.telemetry` — read-only probes (per-cluster
  consensus divergence, post-mixing residual, dispersion, grad norms)
  plus host-side ``core/theory.py`` bound gauges (``sigma_t``,
  Proposition 1, Lemma 1) so bound-vs-actual is one JSONL stream.
* :mod:`~repro_torch.obs.manifest` — the run manifest (config hash, git
  SHA, devices, backend) written next to every JSONL/trace.

``make_obs(trace_dir)`` builds the whole sink; ``NULL_OBS`` is the
free disabled default every instrumented call site holds.
"""
from repro_torch.obs.sink import NULL_OBS, Observability, ObsConfig, make_obs
from repro_torch.obs.trace import (
    Tracer, make_profiler, profiler_trace, validate_chrome_trace)
from repro_torch.obs.manifest import (
    config_hash, git_sha, mesh_info, write_manifest)
from repro_torch.obs.telemetry import (
    TheoryGauges, default_constants, emit_comm, make_divergence_probe,
    make_scale_grad_probe, make_sim_grad_probe, sigma_t_general)

__all__ = [
    "NULL_OBS", "ObsConfig", "Observability", "TheoryGauges", "Tracer",
    "config_hash", "default_constants", "emit_comm", "git_sha",
    "make_divergence_probe", "make_obs", "make_profiler",
    "make_scale_grad_probe", "make_sim_grad_probe", "mesh_info",
    "profiler_trace", "sigma_t_general", "validate_chrome_trace",
    "write_manifest",
]
