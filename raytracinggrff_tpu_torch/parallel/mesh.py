"""The ('rays', 'freq') device mesh of raytracinggrff_tpu/parallel/mesh.py in
PyTorch's idiom: one process per device, joined by a torch.distributed
process group.

Every (pixel, frequency) of a map is independent, so the map shards the ray
axis and, where it divides evenly, the frequency axis; nothing crosses
ranks until the fluxes are gathered once at the end. Rank r holds mesh
coordinates (r // n_freq_shards, r % n_freq_shards), the row-major layout
of the JAX make_mesh. Ray i belongs to ray shard i mod n_ray_shards: the
counterpart of the JAX package's round-robin tile interleave, which spreads
any concentration of rays in the image plane over every shard. Ranks that
share a ray index trace the same rays (the JAX trace is replicated over
'freq') and fold different frequency blocks into their carries. Every rank
builds its own cubes: the resample is deterministic, so no broadcast is
needed.

Backends: `backend=None` picks nccl for CUDA devices and gloo for the CPU.
A failed NCCL init raises; nothing falls back to gloo. NCCL refuses two
ranks on one card, so such a mesh needs backend='gloo'.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("rays", "freq")
# a rank that dies must not hang its peers' collectives for long
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def mesh_layout(world_size, n_ray_shards=None, n_freq_shards=1):
    """(n_ray_shards, n_freq_shards) for `world_size` ranks: the JAX
    make_mesh's rule, with n_ray_shards = world_size // n_freq_shards by
    default. Raises ValueError unless the product is world_size."""
    if n_ray_shards is None:
        n_ray_shards = world_size // n_freq_shards
    if n_ray_shards < 1 or n_freq_shards < 1 or \
            n_ray_shards * n_freq_shards != world_size:
        raise ValueError(f"mesh {n_ray_shards}x{n_freq_shards} != "
                         f"{world_size} devices")
    return int(n_ray_shards), int(n_freq_shards)


def rank_coords(rank, n_freq_shards):
    """(ray_index, freq_index) of `rank` in the row-major mesh."""
    return rank // n_freq_shards, rank % n_freq_shards


def default_backend(device):
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(devices, backend):
    """Refuse an NCCL mesh with two ranks on one card (NCCL fails on
    duplicate devices) and a rank on a card that does not exist."""
    devices = [torch.device(d) for d in devices]
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("backend='nccl' needs CUDA devices")
        if len(set(devices)) < len(devices):
            raise ValueError(
                f"NCCL refuses two ranks on one device ({devices}); pass "
                f"backend='gloo' to share a card between ranks")
    n_cuda = torch.cuda.device_count()
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= n_cuda:
            raise ValueError(f"{d} does not exist: {n_cuda} CUDA device(s)")
    return devices


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """This rank's view of the ('rays', 'freq') mesh."""
    shape: tuple            # (n_ray_shards, n_freq_shards)
    ray_index: int
    freq_index: int
    device: torch.device
    group: object           # the torch.distributed process group
    axis_names: tuple = AXIS_NAMES

    @property
    def rank(self):
        return self.ray_index * self.shape[1] + self.freq_index

    @property
    def size(self):
        return self.shape[0] * self.shape[1]


def make_mesh(n_ray_shards=None, n_freq_shards=1, devices=None,
              backend=None) -> RayMesh:
    """This process's RayMesh over the world's ranks. RANK, WORLD_SIZE and
    LOCAL_RANK are read as torchrun sets them (defaults 0, 1, RANK); with
    no process group yet, one is joined through torchrun's env:// rendezvous
    (MASTER_ADDR, MASTER_PORT). `devices` lists one device per local rank
    (default cuda:LOCAL_RANK, which must exist); `backend` None picks nccl
    for CUDA and gloo for the CPU, unless a group exists, whose backend
    holds. Returns once every rank has joined, after one all_gather, which
    also sets up the group's communicator (NCCL's takes about a second)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    shape = mesh_layout(world, n_ray_shards, n_freq_shards)
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if local_rank >= n_cuda:
            raise ValueError(
                f"LOCAL_RANK {local_rank} has no CUDA device ({n_cuda} "
                f"present); pass devices= to place ranks")
        devices = [f"cuda:{i}" for i in range(n_cuda)]
    if local_rank >= len(devices):
        raise ValueError(f"LOCAL_RANK {local_rank} has no entry in "
                         f"devices ({len(devices)})")
    device = torch.device(devices[local_rank])
    if backend is None:
        backend = default_backend(device)
    check_devices(devices, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
    mesh = RayMesh(shape, *rank_coords(rank, shape[1]), device,
                   dist.group.WORLD)
    all_gather(torch.zeros(1, device=device), mesh)
    return mesh


def ray_shard_size(n_rays, n_shards, index):
    """Rays of ray shard `index`: those i < n_rays with i mod n_shards ==
    index."""
    return len(range(index, n_rays, n_shards))


def shard_rays(arr, mesh: RayMesh):
    """This rank's rays of the leading (ray) axis: ray i belongs to ray
    shard i mod n_ray_shards (numpy arrays or tensors)."""
    return arr[mesh.ray_index::mesh.shape[0]]


def freq_slice(nf, n_freq_shards, freq_index):
    """The slice of `nf` frequencies held at freq_index: a block of
    nf / n_freq_shards where that divides evenly, else all of them
    (replicated), the rule of raytracinggrff_tpu/pipeline.py:423-424."""
    if n_freq_shards > 1 and nf % n_freq_shards == 0:
        w = nf // n_freq_shards
        return slice(freq_index * w, (freq_index + 1) * w)
    return slice(0, nf)


def shard_freqs(arr, mesh: RayMesh, axis=0):
    """This rank's frequency block of `arr` along `axis` (freq_slice)."""
    index = [slice(None)] * np.ndim(arr)
    index[axis] = freq_slice(np.shape(arr)[axis], mesh.shape[1],
                             mesh.freq_index)
    return arr[tuple(index)]


def replicate(arr, mesh: RayMesh):
    """`arr` as a tensor on this rank's device. Every rank builds the same
    cubes itself, so replication needs no collective."""
    return torch.as_tensor(arr, device=mesh.device)


def all_gather(t, mesh: RayMesh):
    """Every rank's tensor `t` (one shape on every rank), in rank order, on
    this rank's device: one all_gather, through host copies with gloo."""
    via = "cpu" if dist.get_backend(mesh.group) == "gloo" else t.device
    out = [torch.empty_like(t, device=via) for _ in range(mesh.size)]
    dist.all_gather(out, t.to(via), group=mesh.group)
    return [o.to(t.device) for o in out]


def gather_rays(local, mesh: RayMesh, n_rays, nf):
    """The inverse of shard_rays on the leading axis and of shard_freqs on
    the last one: each rank's (n_local, ..., nf_local) block goes into the
    full (n_rays, ..., nf) array, on every rank. The blocks are padded to
    the longest ray shard for one all_gather over the group."""
    n_r, n_f = mesh.shape
    padded = local.new_zeros((-(-n_rays // n_r), *local.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((n_rays, *local.shape[1:-1], nf))
    for rank, block in enumerate(all_gather(padded, mesh)):
        ri, fi = rank_coords(rank, n_f)
        out[ri::n_r, ..., freq_slice(nf, n_f, fi)] = \
            block[:ray_shard_size(n_rays, n_r, ri)]
    return out
