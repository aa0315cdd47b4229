"""The hybrid kind (recurrentgemma-9b) through the port's three request
schedulers, against the reference on the CPU (the serve CLI is in
``tests/test_torch_serve_hybrid_cli.py``), with the reduced 5-layer
config of ``tests/test_torch_hybrid.py`` (one ``(rec, rec, attn)``
group and a tail of two, d 64, an ``attention_window`` of 8 below the
prompts) and the reference's weights.

Scheduler tokens, stats and latency records are held exactly at
temperature 0 (they follow from the logits, held to 1e-5 in
``tests/test_torch_hybrid.py``, and from the host bookkeeping).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import pytest

from repro.models import build_model as j_build_model
from repro.serving import (
    BatchScheduler as JBatch, ContinuousScheduler as JContinuous,
    PagedContinuousScheduler as JPaged, Request as JRequest,
    run_trace as j_run_trace,
)

from repro_torch.models import build_model
from repro_torch.serving import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler, Request,
    run_trace,
)

from test_torch_hybrid import WINDOW, _tiny
from test_torch_serving import (
    RECORD_FIELDS, STAT_FIELDS, _settled, _trace)


SCHED_CASES = {
    "paged": (PagedContinuousScheduler, JPaged,
              dict(page_size=4, prefill_chunk=8), 11, 8, 8),
    "paged-deferral": (PagedContinuousScheduler, JPaged,
                       dict(page_size=4, cache_pages=7), 11, 8, 8),
    "continuous": (ContinuousScheduler, JContinuous, {}, 7, 6, 0),
    "wave": (BatchScheduler, JBatch, {}, 7, 6, 0),
}


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedulers_match_reference(case):
    """The reference's traces at temperature 0, prompts of up to 14
    tokens against the window of 8: the same tokens for every request,
    the same stats and latency records; the paged scheduler gives the
    hybrid kind pages but no prefix sharing, and re-admitted slots start
    from a fresh recurrent state."""
    cls, jcls, extra, seed, n_req, template = SCHED_CASES[case]
    cfg, jcfg, p, jp = _tiny()
    kw = dict(slots=2, max_prompt=14, max_total=20, temperature=0.0,
              **extra)
    ref = _trace(jcfg, seed, n_req, JRequest, template)
    mine = _trace(cfg, seed, n_req, Request, template)
    jsched = _settled(jcls(j_build_model(jcfg), **kw))
    sched = cls(build_model(cfg), device="cpu", **kw)
    jstats = j_run_trace(jsched, jp, ref)
    stats = run_trace(sched, p, mine)
    assert stats.requests_done == n_req
    assert max(len(r.prompt) for _, r in mine) > WINDOW
    for (_, a), (_, b) in zip(ref, mine):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    assert [tuple(getattr(r, f) for f in RECORD_FIELDS)
            for r in stats.records] == \
        [tuple(getattr(r, f) for f in RECORD_FIELDS) for r in jstats.records]
    assert stats.prefills > sched.slots        # slots were re-admitted
    if cls is PagedContinuousScheduler:
        for f in ("page_deferrals", "prefix_pages_hit",
                  "prefix_pages_possible"):
            assert getattr(sched, f) == getattr(jsched, f), f
        assert sched.prefix_pages_possible == 0     # no prefix sharing
        assert sched.table.num_free == sched.cache_pages - 1
        if "cache_pages" in extra:
            assert sched.page_deferrals > 0
