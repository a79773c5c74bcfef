"""The multi-device dry run of __graft_entry__.dryrun_multichip on the port.

    python -m raytracinggrff_tpu_torch.parallel.dryrun --n-devices 4
    python -m raytracinggrff_tpu_torch.parallel.dryrun --n-devices 4 \\
        --backend gloo                        # four ranks on one card

It spawns n ranks (parallel.launch.spawn) over an (n/2, 2) mesh, or (n, 1)
for odd n, and runs in each:
  1. a small emission map over the mesh (the graft entry's scene: a
     Newkirk-like density on a 33^3 cube at extent 2.5, 8^2 rays, 40
     steps, 2 frequencies per frequency shard), which must be finite and
     equal to the one-process map;
  2. the segment scenes of __graft_entry__.py:131-184 over the mesh's ray
     shards: 64 central rays, whose records must be finite, and 64 rays in
     a tight arc at the limb, whose straggler factor (the largest ray
     shard's live steps over their mean) must be at most 1.3.
The rank functions live here so that a spawned rank imports only the port.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..grids import UniformGrid
from ..ops.trace_segment import trace_segment
from ..pipeline import RayEmissionConfig, run_ray_tracing_emission
from ..tracer_segments import iter_trace_segments
from .launch import rank_devices, spawn
from .mesh import make_mesh

# the bar of tests/test_streamed_pipeline.py:71-74 for a mesh map against
# the one-process map
TB_RTOL, TB_ATOL, VI_ATOL = 1e-5, 1e-3, 1e-5
STRAGGLER_BAR = 1.3


def small_map(nfreq):
    """The graft entry's scene (__graft_entry__.py:6-51) as pipeline cubes
    (numpy) and the RayEmissionConfig of its emission step."""
    grid = UniformGrid.cube(2.5, 33)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = (4.2e4 * 10 ** (4.32 / np.maximum(r, 0.5))).astype(np.float32)
    cubes = {"omega_pe": (8.93e3 * np.sqrt(ne) * 2 * np.pi).astype(
                 np.float32),
             "ne": ne, "te": np.full_like(ne, 1.4e6),
             "b": (2.0 / np.maximum(r, 0.5) ** 3).astype(np.float32)}
    cfg = RayEmissionConfig(n_pix=8, x_fov=1.44, freq_hz=150e6, grid_n=33,
                            grid_extent=2.5, z_observer=2.5, dt=1e-2,
                            n_steps=40, record_stride=10, nfreq=nfreq,
                            freq_log_step=0.1)
    return cubes, cfg


def segment_scene(n_steps=21, seg_records=3):
    """The segment scene of __graft_entry__.py:131-184 (a 25^3 cube at
    extent 2.5, 80 MHz): the iter_trace_segments arguments other than the
    rays, with numpy cubes."""
    grid = UniformGrid.cube(2.5, 25)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    cubes = [(0.5 * 2 * np.pi * 80e6 * np.exp(-(r - 1) / 0.6)),
             1e8 * np.exp(-(r - 1) / 0.5), np.full_like(r, 1e6),
             np.ones_like(r)]
    return dict(cubes=[c.astype(np.float32) for c in cubes], extent=2.5,
                n=25, freq_hz=80e6, dt=1e-2, n_steps=n_steps,
                record_stride=10, seg_records=seg_records)


def central_rays(rng, n_rays=64):
    """Ray starts at z = 1.9 over the disk centre, |x|, |y| < 0.2."""
    return np.column_stack([rng.uniform(-0.2, 0.2, n_rays),
                            rng.uniform(-0.2, 0.2, n_rays),
                            np.full(n_rays, 1.9)]).astype(np.float32)


def limb_rays(rng, n_rays=64):
    """Ray starts at z = 1.9 in a tight arc near the limb at (x, y) =
    (1, 0): the worst case for a mesh that splits the image plane into
    contiguous blocks."""
    return np.column_stack([rng.uniform(0.9, 1.0, n_rays),
                            rng.uniform(-0.05, 0.05, n_rays),
                            np.full(n_rays, 1.9)]).astype(np.float32)


def trace_scene(common, start, device, mesh=None, stats=None):
    """The records (n_records, 8, n) of one segment scene through
    iter_trace_segments on `device` (a mesh rank's own rays with `mesh`),
    on the host."""
    cubes = [torch.as_tensor(c, device=device) for c in common["cubes"]]
    kdir = np.tile(np.float32([[0.0, 0.0, -1.0]]), (start.shape[0], 1))
    blocks = [r.cpu() for r in iter_trace_segments(
        *cubes, UniformGrid.cube(common["extent"], common["n"]),
        common["freq_hz"], start, kdir, common["dt"], common["n_steps"],
        common["record_stride"], seg_records=common["seg_records"],
        mesh=mesh, stats=stats)]
    return torch.cat(blocks).numpy()


def map_rank(devices, shape, config, cubes=None, model_path=None):
    """One rank of a map over a `shape` mesh: run_ray_tracing_emission
    on its device from numpy `cubes` or a MAS `model_path`. Returns the map,
    the rank's mesh coordinates, wall seconds, stage timings and its
    trace-kernel launches."""
    mesh = make_mesh(*shape, devices=devices)
    timings = {}
    trace_segment.launches = 0
    t0 = time.perf_counter()
    res = run_ray_tracing_emission(
        model_path=model_path, config=config, verbose=False, mesh=mesh,
        device=mesh.device, timings=timings, cubes=cubes)
    wall = time.perf_counter() - t0
    return {"rank": mesh.rank, "coords": (mesh.ray_index, mesh.freq_index),
            "emission_cube": res["emission_cube"],
            "emission_polVI_cube": res["emission_polVI_cube"],
            "wall": wall, "timings": timings,
            "launches": trace_segment.launches}


def scenes_rank(devices, shape, common, starts):
    """One rank of the segment scenes over a `shape` mesh: per scene this
    rank's records and the trace's shard statistics."""
    mesh = make_mesh(*shape, devices=devices)
    out = []
    for start in starts:
        stats = {}
        out.append((trace_scene(common, start, mesh.device, mesh, stats),
                    stats))
    return out


def dryrun_rank(devices, shape, config, cubes, common, starts):
    maps = map_rank(devices, shape, config, cubes)
    t0 = time.perf_counter()
    scenes = scenes_rank(devices, shape, common, starts)
    maps["scenes_wall"] = time.perf_counter() - t0
    return maps, scenes


def dryrun_multichip(n_devices, device="cuda", backend=None, verbose=True):
    """Both parts of the JAX dry run over n_devices ranks on `device`
    ("cuda": the ranks dealt over the cards; "cuda:0" or "cpu": every rank
    there; ranks that share a card need backend='gloo').
    Raises AssertionError if a check fails; returns a summary dict."""
    n_freq = 2 if n_devices % 2 == 0 else 1
    shape = (n_devices // n_freq, n_freq)
    cubes, cfg = small_map(nfreq=2 * n_freq)
    common = segment_scene()
    rng = np.random.default_rng(0)
    starts = [central_rays(rng), limb_rays(rng)]
    dev0 = rank_devices(device, n_devices)[0]
    t0 = time.perf_counter()
    one = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                   device=dev0)
    t1 = time.perf_counter()
    results = spawn(dryrun_rank, n_devices, device, backend,
                    args=(shape, cfg, cubes, common, starts))
    summary = {"n_devices": n_devices, "mesh": shape, "ranks": [],
               "one_process_s": t1 - t0,
               "spawn_s": time.perf_counter() - t1}
    d_tb = d_vi = 0.0
    for maps, scenes in results:
        tb, vi = maps["emission_cube"], maps["emission_polVI_cube"]
        assert tb.shape == one["emission_cube"].shape and \
            np.all(np.isfinite(tb)), tb.shape
        np.testing.assert_allclose(tb, one["emission_cube"], rtol=TB_RTOL,
                                   atol=TB_ATOL)
        np.testing.assert_allclose(vi, one["emission_polVI_cube"],
                                   atol=VI_ATOL)
        d_tb = max(d_tb, float(np.max(np.abs(tb - one["emission_cube"]))))
        d_vi = max(d_vi, float(np.max(np.abs(
            vi - one["emission_polVI_cube"]))))
        (central, _), (_, limb_stats) = scenes
        assert np.all(np.isfinite(central)), "non-finite central records"
        summary["ranks"].append({
            "rank": maps["rank"], "coords": maps["coords"],
            "wall": maps["wall"], "scenes_wall": maps["scenes_wall"],
            "timings": maps["timings"], "launches": maps["launches"]})
    limb = results[0][1][1][1]
    sf = limb["straggler_factor"]
    summary.update(max_abs_tb=d_tb, max_abs_vi=d_vi, straggler_factor=sf,
                   shard_live_steps=limb["shard_live_steps"])
    if verbose:
        print(f"[dryrun] {n_devices} ranks on {device}, mesh {shape}: map "
              f"max |dT_b| {d_tb:.3g} K, |dV/I| {d_vi:.3g} vs one process; "
              f"limb-concentrated shard balance: straggler={sf} "
              f"shard_live_steps={limb['shard_live_steps']}; one-process "
              f"map {summary['one_process_s']:.3f} s, spawn to results "
              f"{summary['spawn_s']:.3f} s, per rank map/scenes "
              + ", ".join(f"{r['wall']:.3f}/{r['scenes_wall']:.3f} s"
                          for r in summary["ranks"]))
    assert sf <= STRAGGLER_BAR, f"shard imbalance {sf} > {STRAGGLER_BAR}"
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks (default: the CUDA device count)")
    p.add_argument("--device", default="cuda",
                   help="cuda (ranks dealt over the cards), cuda:N or cpu")
    p.add_argument("--backend", default=None, help="nccl or gloo")
    args = p.parse_args(argv)
    n = args.n_devices or torch.cuda.device_count()
    if n < 1:
        raise SystemExit("no CUDA device: pass --n-devices and --device cpu")
    summary = dryrun_multichip(n, args.device, args.backend)
    print(json.dumps({k: v for k, v in summary.items() if k != "ranks"}))
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main()
