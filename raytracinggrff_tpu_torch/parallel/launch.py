"""Run a function in n ranks on one host: the counterpart of the JAX
package's __graft_entry__._ensure_devices, which made a virtual device mesh
for the JAX dry run.

    results = spawn(fn, n_procs, device="cuda", backend=None, args=())

Each rank is a process started by torch.multiprocessing (spawn start
method) that joins one process group through a FileStore in a temporary
directory, never a TCP port, so that several runs on one host cannot
collide. It then calls fn(devices, *args), where `devices` lists the
device of each local rank (make_mesh's `devices`), and returns fn's
results in rank order. fn must be a module-level function of a module that
a fresh process can import without side effects.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import GROUP_TIMEOUT, check_devices, default_backend


def rank_devices(device, n_procs):
    """One device per rank: "cuda" deals the ranks over the cards in turn
    (rank i on cuda:i where there are as many cards); any other device
    (cuda:0, cpu) holds every rank."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        n = torch.cuda.device_count()
        return [f"cuda:{i % n if n else i}" for i in range(n_procs)]
    return [str(d)] * n_procs


def init_group(store_path, rank, world_size, backend):
    """Join the process group of `world_size` ranks that rendezvous in the
    FileStore at store_path."""
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)


def _rank_main(rank, fn, n_procs, devices, backend, workdir, threads):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n_procs))
    with open(Path(workdir) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    torch.set_num_threads(threads)
    if torch.device(devices[rank]).type == "cuda":
        torch.cuda.set_device(devices[rank])
    init_group(Path(workdir) / "store", rank, n_procs, backend)
    try:
        result = fn(devices, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(fn, n_procs, device="cuda", backend=None, args=()):
    """Run fn(devices, *args) in n_procs ranks joined by one process group
    and return the results in rank order. backend None picks nccl for CUDA
    and gloo for the CPU; two ranks on one card need backend='gloo'. Each
    rank uses as many torch threads as the caller. A rank that raises makes
    spawn raise; its peers are stopped. On a CUDA device the trace kernel
    is built here first, so that the ranks do not each run nvcc. `args`
    reach the ranks through a file: a start-up message larger than a pipe
    holds would block this process until each rank in turn had imported
    torch, so that the ranks would start one after another."""
    devices = rank_devices(device, n_procs)
    backend = backend or default_backend(devices[0])
    check_devices(devices, backend)
    if torch.device(devices[0]).type == "cuda":
        from ..ops._build import build_library
        build_library()
    workdir = tempfile.mkdtemp(prefix="rgrff_spawn_")
    try:
        with open(Path(workdir) / "args.pkl", "wb") as f:
            pickle.dump(tuple(args), f)
        mp.spawn(_rank_main, nprocs=n_procs, join=True,
                 args=(fn, n_procs, devices, backend, workdir,
                       torch.get_num_threads()))
        results = []
        for rank in range(n_procs):
            with open(Path(workdir) / f"result_{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
