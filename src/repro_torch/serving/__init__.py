"""Public serving API of the port: engine primitives, schedulers,
sampling, the page table and the sharding layer's serve tables — the
names of ``repro/serving/__init__.py``.

Import from here; ``launch/serve.py`` and the tests do not deep-import
``repro_torch.serving.*`` modules.
"""
from repro_torch.serving.engine import (
    cache_logical_axes_tree, decode_step, decode_step_paged, init_cache_tree,
    init_paged_cache_tree, paged_cache_logical_axes_tree, prefill,
    prefill_chunk, write_cache_slot,
)
from repro_torch.serving.pages import (
    DUMMY_PAGE, PageTable, PrefixTrie, pages_per_slot,
)
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.sharding import (
    SERVE_CACHE_RULES, SERVE_PARAM_RULES, ServeShardings, cache_shardings,
    paged_cache_shardings, param_shardings, serve_shardings, shard_params,
)
from repro_torch.serving.scheduler import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler,
    Request, RequestRecord, SchedulerStats, make_scheduler, run_trace,
)

__all__ = [
    "init_cache_tree", "cache_logical_axes_tree", "prefill",
    "decode_step", "write_cache_slot", "init_paged_cache_tree",
    "paged_cache_logical_axes_tree", "prefill_chunk", "decode_step_paged",
    "DUMMY_PAGE", "PageTable", "PrefixTrie", "pages_per_slot",
    "sample_tokens",
    "BatchScheduler", "ContinuousScheduler", "PagedContinuousScheduler",
    "Request", "RequestRecord", "SchedulerStats", "make_scheduler",
    "run_trace",
    "SERVE_PARAM_RULES", "SERVE_CACHE_RULES", "ServeShardings",
    "serve_shardings", "param_shardings", "cache_shardings",
    "paged_cache_shardings", "shard_params",
]
