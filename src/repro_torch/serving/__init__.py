"""Public serving API of the port: engine primitives, schedulers,
sampling and the page table — ``repro/serving/__init__.py`` without the
sharding names (ROADMAP.md Queue 1 item 8).

Import from here; ``launch/serve.py`` and the tests do not deep-import
``repro_torch.serving.*`` modules.
"""
from repro_torch.serving.engine import (
    decode_step, decode_step_paged, init_cache_tree, init_paged_cache_tree,
    prefill, prefill_chunk, write_cache_slot,
)
from repro_torch.serving.pages import (
    DUMMY_PAGE, PageTable, PrefixTrie, pages_per_slot,
)
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler,
    Request, RequestRecord, SchedulerStats, make_scheduler, run_trace,
)

__all__ = [
    "init_cache_tree", "prefill", "decode_step", "write_cache_slot",
    "init_paged_cache_tree", "prefill_chunk", "decode_step_paged",
    "DUMMY_PAGE", "PageTable", "PrefixTrie", "pages_per_slot",
    "sample_tokens",
    "BatchScheduler", "ContinuousScheduler", "PagedContinuousScheduler",
    "Request", "RequestRecord", "SchedulerStats", "make_scheduler",
    "run_trace",
]
