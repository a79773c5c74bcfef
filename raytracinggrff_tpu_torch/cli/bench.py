"""Benchmark CLI on PyTorch/CUDA: LOS sampling and trace throughput on a
synthetic cube, as the JAX package's rgrff-bench measures itself
(reference bench harness, bench_raytrace.py:16-101).

LOS sampling runs sampler.sample_model_with_rays on --device (default
cuda) on a model table packed outside the timed call. The trace runs the
trace-segment kernel through tracer_segments.run_segments (cross-sections
on, 150 MHz, dt 5e-3, stride 10) and keeps its records on the device, as
the JAX bench keeps trace_rays' records. Its kernel inputs (trace and
sample cubes, initial state) are made once, outside the timed call, as
the JAX bench packs its trace table outside it: the timed call is the
kernel launches alone, each of which also samples ne/te/b at its
records. Each time is the best of --repeat runs after one warm-up, taken
after torch.cuda.synchronize() on a card. It prints samples/s and
ray-steps/s.

    python -m raytracinggrff_tpu_torch.cli.bench
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_case(n_pix, n_steps, grid_n, seed=0):
    """Synthetic Gaussian-density cube + jittered vertical rays
    (workload of bench_raytrace.py:16-41)."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-2.0, 2.0, grid_n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    ne = (1.0e8 + 2.0e8 * np.exp(-(x * x + y * y + z * z))).astype(np.float32)
    te = (1.0e6 + 2.0e6 * (x + 2 * y - z)).astype(np.float32)
    b = (2.0 + x - y + 0.5 * z).astype(np.float32)

    n_rays = n_pix * n_pix
    origin_xy = rng.uniform(-1.2, 1.2, size=(n_rays, 2)).astype(np.float32)
    origin = np.column_stack([origin_xy,
                              np.full(n_rays, 2.5, dtype=np.float32)])
    dirs = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_rays, 1))
    dirs[:, 0:2] += rng.normal(scale=0.02, size=(n_rays, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    s = (np.arange(n_steps, dtype=np.float32) * 0.02)[:, None]
    r_record = origin[None, :, :] + s[:, :, None] * dirs[None, :, :]
    s_arr = np.ones((n_steps, n_rays), dtype=np.float32)
    return g, ne, te, b, r_record, s_arr, origin, dirs


def build_parser():
    p = argparse.ArgumentParser(description="Benchmark LOS sampling and "
                                            "ray tracing on a torch device")
    p.add_argument("--n-pix", type=int, default=256)
    p.add_argument("--n-steps", type=int, default=256)
    p.add_argument("--grid-n", type=int, default=128)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--trace-steps", type=int, default=1000,
                   help="RK4 steps for the tracer benchmark")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..grids import UniformGrid
    from ..sampler import pack_model_table, sample_model_with_rays
    from ..tracer_segments import (initial_state, prepare_trace_inputs,
                                   run_segments)

    device = torch.device(args.device)
    g, ne, te, b, r_record, s_arr, origin, dirs = make_case(
        args.n_pix, args.n_steps, args.grid_n)
    grid = UniformGrid.from_arrays(g, g, g)
    n_samples = args.n_pix * args.n_pix * args.n_steps

    def t(a):
        return torch.as_tensor(a, device=device)

    ne_t, te_t, b_t = t(ne), t(te), t(b)
    table = pack_model_table(ne_t, te_t, b_t)
    pos, s, start = t(r_record), t(s_arr), t(origin)

    def run_sample():
        return sample_model_with_rays(table, grid, pos, s, start)

    _time(run_sample, device)
    best = min(_time(run_sample, device) for _ in range(args.repeat))
    print(f"LOS sampling best: {best:.4f} s "
          f"({n_samples / best:,.0f} samples/s)")

    omega_pe = 8.93e3 * np.sqrt(np.maximum(ne, 0)) * 2 * np.pi
    tcube, scube = prepare_trace_inputs(t(omega_pe.astype(np.float32)),
                                        ne_t, te_t, b_t, grid)
    state = initial_state(tcube, grid, 150e6, origin, dirs)

    def run_trace():
        return list(run_segments(tcube, scube, state, grid, 5e-3,
                                 args.trace_steps, 10,
                                 trace_crosssections=True))

    _time(run_trace, device)
    best_t = min(_time(run_trace, device) for _ in range(args.repeat))
    ray_steps = args.n_pix * args.n_pix * args.trace_steps
    print(f"Trace best: {best_t:.4f} s "
          f"({ray_steps / best_t:,.0f} ray-steps/s, cross-sections on)")


def _time(fn, device):
    """Seconds of fn(), with the device drained before and after."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
