"""``repro_torch.dist`` — the logical-axis sharding layer, the port of
``repro/dist``.

Owns the mapping from model-declared logical axes to the dims of a
``torch.distributed`` ``DeviceMesh``. Model code imports :func:`hint`;
the serving layer builds :class:`ShardingRules` tables and resolves
them to ``DTensor`` placements; :func:`use_mesh` makes a mesh ambient.
"""
from repro_torch.dist.sharding import (
    AbstractMesh, ShardingRules, ambient_mesh, drop_hint_axes, hint,
    placements, use_mesh)

__all__ = ["AbstractMesh", "ShardingRules", "ambient_mesh",
           "drop_hint_axes", "hint", "placements", "use_mesh"]
