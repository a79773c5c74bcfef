"""Which on-disk pixels of a TbSpectra sweep map lie outside 1e4..3e6 K in
the port, and what the JAX package gives on the same rays, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_sweep_pixels_vs_jax.py

The map is the sweep's at `--index` of its 30 default frequencies, on the
synthetic MAS model that chip_smoke.py and profile_slice.py sweep (the
lattice preset of cli/tb_spectra.py, phi0 -140, 128^2 pixels, S input off,
mechanism 5). The port resamples the cubes and runs the whole map in plain
torch (index 19: a 512^3 cube, 4,600 steps, about 5 minutes with 4 threads
and 8 GiB); the JAX XLA tracer, sampler and get_mw_slice then take the
flagged rays, and as many lit on-disk control rays, on the same cubes.
Prints both packages' T_b on the flagged rays, the controls' largest
relative difference, and where the flagged rays went: the fewest valid
records, their deepest point and the largest f_p/f over their valid
records.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

from raytracinggrff_tpu.grff.transfer import get_mw_slice as jax_get_mw_slice
from raytracinggrff_tpu.grff.transfer import tb_from_sfu as jax_tb_from_sfu
from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu.sampler import (pack_model_table,
                                        sample_model_with_rays)
from raytracinggrff_tpu.tracer import pack_trace_table, trace_rays
from raytracinggrff_tpu_torch.cli.tb_spectra import (quantize_params,
                                                     select_params,
                                                     sweep_frequencies)
from raytracinggrff_tpu_torch.constants import FPE_COEF, R_SUN_CM
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.mas.model import MASModel, synthetic_mas_model
from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                               image_ray_starts,
                                               prepare_cubes,
                                               run_ray_tracing_emission)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--index", type=int, default=19)
    p.add_argument("--n-pix", type=int, default=128)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    f = float(sweep_frequencies()[args.index])
    prm = quantize_params(select_params(f))
    print(f"index {args.index}: {f / 1e6:.3f} MHz, preset {prm}")
    grid = UniformGrid.cube(prm["grid_extent"], prm["grid_n"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model = synthetic_mas_model(f"{tmp}/corona")
        cubes = prepare_cubes(MASModel(model), grid, -140.0, verbose=False,
                              device="cpu")
    cfg = RayEmissionConfig(
        n_pix=args.n_pix, x_fov=float(prm["x_fov"]), freq_hz=f,
        grid_n=int(prm["grid_n"]), grid_extent=float(prm["grid_extent"]),
        z_observer=float(prm["z_observer"]), dt=float(prm["dt"]),
        n_steps=int(prm["n_steps"]), record_stride=int(prm["record_stride"]),
        nfreq=1, freq0=f, phi0_offset=-140.0)
    tb_port = run_ray_tracing_emission(cubes=cubes, config=cfg,
                                       verbose=False, device="cpu")[
        "emission_cube"][:, :, 0].reshape(-1)
    print(f"port map (plain torch, CPU): {time.perf_counter() - t0:.1f} s")
    xs = np.linspace(-cfg.x_fov, cfg.x_fov, cfg.n_pix)
    disk = ((xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0).reshape(-1)
    flagged = np.flatnonzero(disk & ~((tb_port > 1e4) & (tb_port < 3e6)))
    print(f"{flagged.size} of {disk.sum()} on-disk values outside "
          f"1e4..3e6 K; flat pixel indices (i * {cfg.n_pix} + j): "
          f"{flagged.tolist()}")
    if flagged.size == 0:
        return
    lit = np.flatnonzero(disk & (tb_port > 1e4) & (tb_port < 3e6))
    control = np.random.default_rng(0).choice(
        lit, min(flagged.size, lit.size), replace=False)
    rays = np.concatenate([flagged, control])

    _, _, start, kdir = image_ray_starts(cfg.n_pix, cfg.x_fov, cfg.z_observer)
    jgrid = JaxGrid.cube(prm["grid_extent"], prm["grid_n"])
    table = pack_trace_table(jnp.asarray(cubes["omega_pe"].numpy()), jgrid)
    mtable = pack_model_table(*(jnp.asarray(cubes[k].numpy())
                                for k in ("ne", "te", "b")))
    del cubes
    t0 = time.perf_counter()
    tr = trace_rays(table, jgrid, f, jnp.asarray(start[rays]),
                    jnp.asarray(kdir[rays]), cfg.dt, cfg.n_steps,
                    cfg.record_stride, trace_crosssections=True)
    los = sample_model_with_rays(mtable, jgrid, tr.r_record, tr.s_record,
                                 jnp.asarray(start[rays]))
    area = ((2 * cfg.x_fov) / cfg.n_pix * R_SUN_CM) ** 2
    res = jax_get_mw_slice(los.ds, los.te, los.ne, los.b, los.valid_mask, f,
                           1, 0.0, area, theta_deg=cfg.theta_deg,
                           mechanism=cfg.mechanism, gaunt=cfg.gaunt)
    tb_jax = np.asarray(jax_tb_from_sfu(res.flux_o + res.flux_x,
                                        jnp.asarray([f], jnp.float32),
                                        area))[:, 0]
    print(f"JAX XLA path on {rays.size} rays: "
          f"{time.perf_counter() - t0:.1f} s")
    n = flagged.size
    print(f"flagged rays, T_b port: {tb_port[flagged].tolist()}")
    print(f"flagged rays, T_b JAX:  {tb_jax[:n].tolist()}")
    rel = np.abs(tb_jax[n:] / tb_port[control] - 1.0)
    print(f"control rays: max relative T_b difference {rel.max():.4g}")
    valid = np.asarray(los.valid_mask)[:, :n]
    depth = np.sqrt(np.sum(np.asarray(tr.r_record)[:, :n] ** 2, axis=-1))
    fp = FPE_COEF * np.sqrt(np.where(valid, np.asarray(los.ne)[:, :n], 0.0))
    print(f"flagged rays: valid records {valid.sum(0).min()}-"
          f"{valid.sum(0).max()} of {valid.shape[0]}; deepest r "
          f"{depth.min(0).min():.3f}-{depth.min(0).max():.3f} R_sun; max "
          f"f_p/f over valid records {(fp.max(0) / f).min():.4f}-"
          f"{(fp.max(0) / f).max():.4f}")


if __name__ == "__main__":
    main()
