"""Several ranks, one device each, over `torch.distributed` (counterpart
of instant_ngp_tpu/parallel/).

- `mesh.py`: meshes with named axes, the collectives, and the placement
  helpers `replicate`, `shard_along` and `shard_batch`;
- `tp.py`: the hash grid sharded by level over a `model` axis, and the
  hybrid data x model NeRF train step;
- `ranks.py`: a pool of spawned ranks on one host, for the tests and
  chip_smoke.py.
The data-parallel NeRF steps are in nerf/parallel.py.
"""

from .mesh import (Mesh, data_parallel_mesh, replicate,  # noqa: F401
                   shard_along, shard_batch)
