"""Multi-device runs: the ('rays', 'freq') mesh over a torch.distributed
process group (mesh.py), a launcher for n ranks on one host (launch.py) and
the multi-device dry run (dryrun.py, `python -m
raytracinggrff_tpu_torch.parallel.dryrun`)."""

from .launch import spawn
from .mesh import (RayMesh, gather_rays, make_mesh, mesh_layout, replicate,
                   shard_freqs, shard_rays)

__all__ = ["RayMesh", "make_mesh", "mesh_layout", "shard_rays",
           "gather_rays", "shard_freqs", "replicate", "spawn"]
