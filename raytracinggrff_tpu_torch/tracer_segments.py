"""Segment driver for the trace kernel: the counterpart of the JAX
package's tracer_pallas.py.

`iter_trace_segments` prepares the kernel inputs once (channels-last trace
and sample cubes, one launch of their own kernel on a card; initial wave
vectors) and then `run_segments` launches
ops/trace_segment.trace_segment once per segment, yielding (rps, 8, n_rays)
record blocks with rows [x, y, z, S, ne, te, b, cos_theta] in the
original ray order. Segments only bound the record memory: the ray state
stays on the device between them, and step counts are runtime arguments, so
the last segment runs exactly the steps its records need.

A GPU thread reads the cube from L2/HBM directly, so none of the TPU
driver's machinery is carried over: no kd/capacity binning, parking, retry
or tail traces, bricks, reload margins or escape statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .grids import UniformGrid
from .ops.trace_segment import pack_trace_inputs, trace_segment
from .parallel.mesh import all_gather, shard_rays
from .tracer import init_k_vectors
from .utils import profiling


class SegmentTraceResult(NamedTuple):
    r_record: np.ndarray   # (n_records, n_rays, 3)
    s_record: np.ndarray   # (n_records, n_rays) S of the s_mode
    ne: np.ndarray         # (n_records, n_rays)
    te: np.ndarray
    b: np.ndarray
    cos_theta: np.ndarray | None = None  # signed cos(B, k) with bvec


def prepare_trace_inputs(omega_pe_cube, ne_cube, te_cube, b_cube,
                         grid: UniformGrid, bvec=None):
    """Channels-last float32 kernel cubes in the flat order of
    ops/trilinear.pack_fields: the trace cube (nx, ny, nz, 4) =
    [omega_pe, d/dx, d/dy, d/dz] and the sample cube (nx, ny, nz, 4) =
    [ne, te, b, 0], or (nx, ny, nz, 8) = [ne, te, b, Bx, By, Bz, 0, 0]
    with `bvec`. Cubes are tensors on the device the kernel runs on; on a
    card one launch of ops/trace_segment.pack_trace_inputs builds both."""
    return pack_trace_inputs(omega_pe_cube, ne_cube, te_cube, b_cube, grid,
                             bvec)


def segment_plan(n_steps, record_stride, seg_records):
    """[(n_first, rps), ...] per segment and the record count: the first
    record after step 1, then one every record_stride steps, with no
    segment running steps past its last record."""
    n_records = -(-n_steps // record_stride)
    plan = []
    done = 0
    while done < n_records:
        rps = min(seg_records, n_records - done)
        plan.append((1 if done == 0 else record_stride, rps))
        done += rps
    return plan, n_records


def initial_state(tcube, grid: UniformGrid, freq_hz, start, kdir):
    """The kernel's (7, n_rays) start state [x, y, z, kx, ky, kz, S = 1]
    on the device of `tcube`, with the wave vectors of init_k_vectors.
    start, kdir: (n_rays, 3) arrays or tensors."""
    device = tcube.device
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    kdir = torch.as_tensor(kdir, dtype=torch.float32, device=device)
    k0 = init_k_vectors(tcube.reshape(-1, 4), grid, freq_hz, start, kdir)
    ones = torch.ones((1, start.shape[0]), dtype=torch.float32,
                      device=device)
    return torch.cat([start.T, k0.T, ones]).contiguous()


def run_segments(tcube, scube, state, grid: UniformGrid, dt, n_steps,
                 record_stride=10, trace_crosssections=True,
                 perturb_ratio=2.0, seg_records=64, s_mode="cumulative"):
    """Launch trace_segment once per segment of segment_plan on prepared
    kernel inputs (prepare_trace_inputs, initial_state) and yield each
    segment's (rps, 8, n_rays) record block."""
    plan, _ = segment_plan(n_steps, record_stride, seg_records)
    for n_first, rps in plan:
        state, records = trace_segment(
            tcube, scube, state, grid, dt, n_first, record_stride, rps,
            perturb_ratio, trace_crosssections, s_mode)
        yield records


def iter_trace_segments(omega_pe_cube, ne_cube, te_cube, b_cube,
                        grid: UniformGrid, freq_hz, start, kdir, dt, n_steps,
                        record_stride=10, trace_crosssections=True,
                        perturb_ratio=2.0, seg_records=64, bvec=None,
                        s_mode="cumulative", mesh=None, stats=None):
    """Yield (rps, 8, n_rays) record blocks, one per segment, on the
    device of `omega_pe_cube`. start, kdir: (n_rays, 3) arrays or
    tensors. `bvec` (image-frame Cartesian B cubes) makes row 7 the signed
    cos(theta) between B and the wave vector; otherwise it is 0. Row 3
    holds cumulative S, or with s_mode='per_step' the ratio of each
    record's last step.

    With `mesh` (a parallel.mesh.RayMesh; the cubes on mesh.device),
    start and kdir still list every ray, and each rank traces its own ray
    shard (ray i on shard i mod n_ray_shards) and yields that shard's
    (rps, 8, n_local) blocks; the JAX generator yields the global array,
    sharded over 'rays', instead. A dict passed as `stats` then receives
    'shard_live_steps', per ray shard the steps of records with S > 0 and
    a finite position (summed on the device, read once at the end and
    all-gathered), and 'straggler_factor', their max over their mean. So
    every rank of the group must run the generator to its end.

    Span (utils/profiling): "trace_inputs", the kernel cubes and the start
    state, on the device clock."""
    if mesh is not None:
        start, kdir = shard_rays(start, mesh), shard_rays(kdir, mesh)
    with profiling.span("trace_inputs", "device"):
        # The rays go up before the cubes' launch: a copy from pageable
        # host memory waits for the stream, so after the launch it would
        # hold the host until the kernel ends, with the start state's small
        # ops still to queue and the device idle while they are.
        start, kdir = (torch.as_tensor(a, dtype=torch.float32,
                                       device=omega_pe_cube.device)
                       for a in (start, kdir))
        tcube, scube = prepare_trace_inputs(omega_pe_cube, ne_cube, te_cube,
                                            b_cube, grid, bvec)
        state = initial_state(tcube, grid, freq_hz, start, kdir)
    segments = run_segments(tcube, scube, state, grid, dt, n_steps,
                            record_stride, trace_crosssections,
                            perturb_ratio, seg_records, s_mode)
    if mesh is None or stats is None:
        yield from segments
        return
    live = torch.zeros(1, dtype=torch.int64, device=state.device)
    plan, _ = segment_plan(n_steps, record_stride, seg_records)
    for (n_first, rps), recs in zip(plan, segments):
        steps = torch.full((rps,), record_stride, dtype=torch.int64,
                           device=recs.device)
        steps[0] = n_first
        ok = (recs[:, 3] > 0) & torch.isfinite(recs[:, 0:3]).all(dim=1)
        live += (ok.sum(dim=1) * steps).sum()
        yield recs
    per_rank = [int(c) for c in all_gather(live, mesh)]
    shard = per_rank[::mesh.shape[1]]        # freq index 0 of each ray shard
    stats["shard_live_steps"] = shard
    stats["straggler_factor"] = round(
        max(shard) / max(1.0, sum(shard) / len(shard)), 4)


def trace_rays_segments(omega_pe_cube, ne_cube, te_cube, b_cube,
                        grid: UniformGrid, freq_hz, start, kdir, dt, n_steps,
                        record_stride=10, trace_crosssections=True,
                        perturb_ratio=2.0, seg_records=64, bvec=None,
                        s_mode="cumulative") -> SegmentTraceResult:
    """Collect every segment's records on the host (the counterpart of
    trace_rays_pallas, for tests and small traces)."""
    blocks = [r.cpu() for r in iter_trace_segments(
        omega_pe_cube, ne_cube, te_cube, b_cube, grid, freq_hz, start, kdir,
        dt, n_steps, record_stride, trace_crosssections, perturb_ratio,
        seg_records, bvec, s_mode)]
    rec = torch.cat(blocks).numpy().transpose(0, 2, 1)   # (n_rec, n_rays, 8)
    return SegmentTraceResult(
        r_record=rec[:, :, 0:3], s_record=rec[:, :, 3], ne=rec[:, :, 4],
        te=rec[:, :, 5], b=rec[:, :, 6],
        cos_theta=rec[:, :, 7] if bvec is not None else None)
