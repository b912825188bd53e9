"""Distribution layer (counterpart of ``repro/dist``): logical axes and the
path-keyed placement policy.

  logical   logical axis names ("dp"/"tp"/"seq") bound to a mesh's axes by
            a context manager, and the reference's drop rules for them.
  sharding  parameter/cache/batch placement specs keyed on tree paths, their
            DTensor placements on a ``DeviceMesh``, and the placing and
            gathering of a parameter tree.

Every function takes either a ``torch.distributed.device_mesh.DeviceMesh``
or a shape-only :class:`logical.MeshShape` (axis names and sizes, no
ranks): the placements of the 16 x 16 and 2 x 16 x 16 production meshes are
computed from shapes alone. The rules name axes, never device counts
(``ft/elastic.py``).
"""

from repro_torch.dist import logical, sharding

__all__ = ["logical", "sharding"]
