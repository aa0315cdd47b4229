"""repro_torch.hierarchy — multi-stage fog aggregation trees, the port of
``repro/hierarchy/``.

Generalizes TT-HF's two timescales to a configurable L-level
aggregation hierarchy: level 0 is per-cluster D2D consensus (the
unchanged ``core/mixing.py`` engine), levels 1..L-1 are parent-node
aggregations over child subtrees — each tier with its own period and
sampling fan-in — and the root is the global model. Tree construction
(:mod:`tree`) and the presets (:mod:`presets`) are numpy copies; in
:mod:`aggregate` the per-level weight matrices are numpy too, and the
two appliers are torch.
"""
from repro_torch.hierarchy.aggregate import (
    HierarchyEvent, apply_device_matrix_pytree, build_event,
    child_matrix, global_from_weights, interval_depth, live_levels,
    rep_matrix, sample_children,
)
from repro_torch.hierarchy.tree import AggregationTree, build_tree
from repro_torch.hierarchy import presets

__all__ = [
    "AggregationTree", "HierarchyEvent", "apply_device_matrix_pytree",
    "build_event", "build_tree", "child_matrix", "global_from_weights",
    "interval_depth", "live_levels", "presets", "rep_matrix",
    "sample_children",
]
