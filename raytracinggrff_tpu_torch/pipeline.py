"""The imaging pipelines of raytracinggrff_tpu/pipeline.py on torch:

  * run_ray_tracing_emission: resample the MAS model to cubes on the
    device, trace N_pix^2 refracting rays segment by segment with the
    trace-segment kernel, fold every record into the two-mode transfer
    carry, and convert the fluxes to brightness temperature
    (script/resample_with_ray_tracing.py:154-549);
  * resample_mas_los: the straight-LOS sampling baseline
    (script/resampling_MAS_LOS.py:100-309);
  * synthetic_ff: the GRFF transfer of LOS data to a map
    (script/synthetic_FF_map_single_thread.py:108-312).

They keep the result keys and the .npz outputs of the JAX package and run
on `device` ("cuda" by default); a CPU run names device="cpu". The ray map
also runs over a parallel.mesh.RayMesh, one rank per device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from .constants import FPE_COEF, R_SUN_CM, R_SUN_M
from .coords import image_xyz_to_mas_sph
from .grids import UniformGrid, linear_z_grid, variable_z_grid
from .grff.transfer import (get_mw_slice, log_spaced_freqs, tb_from_sfu,
                            transfer_carry_init)
from .mas.model import MASModel, scene_arrays
from .ops import resample, transfer_fold
from .parallel.mesh import (RayMesh, all_gather, gather_rays, shard_freqs,
                            shard_rays)
from .sampler import LosSamples, valid_and_ds
from .tracer import check_s_mode
from .tracer_segments import iter_trace_segments, segment_plan
from .utils import npz, profiling
from .utils.plotting import inspection_pixel_index


# ---------------------------------------------------------------------------
# Scene preparation
# ---------------------------------------------------------------------------

def _finalize_cubes(ne_raw, te_raw, br, bt, bp):
    """Post-resampling cube transforms
    (resample_with_ray_tracing.py:269-293)."""
    ne_raw = torch.nan_to_num(ne_raw, nan=0.0)
    br = torch.nan_to_num(br, nan=0.0)
    bt = torch.nan_to_num(bt, nan=0.0)
    bp = torch.nan_to_num(bp, nan=0.0)
    ne = torch.clamp(ne_raw, min=0.0)
    omega_pe = FPE_COEF * torch.sqrt(ne) * (2.0 * math.pi)
    omega_pe = torch.nan_to_num(omega_pe, nan=0.0, posinf=0.0, neginf=0.0)
    te = torch.where(torch.isfinite(te_raw), te_raw, 1e4)
    b = torch.sqrt(br * br + bt * bt + bp * bp)
    return omega_pe, ne, te, b


def _bvec_image_cubes(br, bt, bp, grid: UniformGrid):
    """Rotate the resampled spherical B components into image-frame
    Cartesian cubes (bx, by, bz) on the grid nodes. The MAS polar axis is
    image +y and MAS Cartesian is (x, -z, y) of the image frame, so with
    rho = sqrt(x^2 + z^2):
        r_hat = (x, y, z)/r,  theta_hat = (x*y, -rho^2, z*y)/(r*rho),
        phi_hat = (z, 0, -x)/rho.
    Nodes on the polar axis (rho = 0) get the rho -> eps limit."""
    xs, ys, zs = (torch.as_tensor(np.asarray(a, np.float32), device=br.device)
                  for a in grid.axes())
    x = xs[:, None, None]
    y = ys[None, :, None]
    z = zs[None, None, :]
    r = torch.sqrt(x * x + y * y + z * z)
    rho = torch.sqrt(x * x + z * z)
    r_s = torch.clamp(r, min=1e-12)
    rho_s = torch.clamp(rho, min=1e-12)
    br = torch.nan_to_num(br, nan=0.0)
    bt = torch.nan_to_num(bt, nan=0.0)
    bp = torch.nan_to_num(bp, nan=0.0)
    bx = br * (x / r_s) + bt * (x * y / (r_s * rho_s)) + bp * (z / rho_s)
    by = br * (y / r_s) + bt * (-rho / r_s)
    bz = br * (z / r_s) + bt * (z * y / (r_s * rho_s)) + bp * (-x / rho_s)
    return bx, by, bz


def prepare_cubes(model: MASModel, grid: UniformGrid, phi0_offset_deg=0.0,
                  verbose=True, keep_bvec=False, device="cuda"):
    """Resample the five MAS variables into the pipeline cubes on
    `device` (one kernel launch on a card, ops/resample.resample_cubes):
    omega_pe (rad/s), ne (cm^-3), te (K), b (G) as float32 tensors, plus
    with keep_bvec "bvec", the image-frame (bx, by, bz) cubes for
    theta_mode='los'. Spans: "read" (the HDF4 reads) and "upload" (the
    copies to the device), on the host clock."""
    with profiling.span("read"):
        temp_var = model.temperature_variable()
        for v in ("br", "bt", "bp"):
            if v not in model.variables:
                raise ValueError(
                    "Magnetic field components (br, bt, bp) not all found.")
        variables = [model[v] for v in ("rho", temp_var, "br", "bt", "bp")]
    if verbose:
        print(f"Resampling rho/{temp_var}/br/bt/bp -> cubes "
              f"({grid.nx}^3, phi0={phi0_offset_deg})...")
    with profiling.span("upload"):
        xs, ys, zs = (torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in grid.axes())
        arrays = scene_arrays(variables, device)
    raw = resample.resample_cubes(arrays, xs, ys, zs, phi0_offset_deg,
                                  fill_nan=None)
    omega_pe, ne, te, b = _finalize_cubes(*raw)
    cubes = {"omega_pe": omega_pe, "ne": ne, "te": te, "b": b}
    if keep_bvec:
        cubes["bvec"] = _bvec_image_cubes(raw[2], raw[3], raw[4], grid)
    return cubes


def cubes_from_numpy(cubes, device):
    """The JAX pipeline's cube dict (omega_pe/ne/te/b, optional bvec
    triple; tensors, numpy arrays or other array-likes) as float32 tensors
    on `device`: tensors move with .to, the rest through numpy."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    out = {k: t(cubes[k]) for k in ("omega_pe", "ne", "te", "b")}
    if cubes.get("bvec") is not None:
        out["bvec"] = tuple(t(c) for c in cubes["bvec"])
    return out


def image_ray_starts(n_pix, x_fov, z_observer):
    """Image-plane ray launch points and directions:
    z_start = sqrt(|(2 z_obs)^2 - x^2 - y^2|)/2, k = -z
    (resample_with_ray_tracing.py:296-303). Pixel p = i*N + j maps to
    (y_i, x_j)."""
    xs = np.linspace(-x_fov, x_fov, n_pix)
    ys = np.linspace(-x_fov, x_fov, n_pix)
    X, Y = np.meshgrid(xs, ys)
    x_flat = X.ravel()
    y_flat = Y.ravel()
    z_start = np.sqrt(np.abs((z_observer * 2.0) ** 2
                             - x_flat ** 2 - y_flat ** 2)) / 2.0
    start = np.column_stack([x_flat, y_flat, z_start]).astype(np.float32)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_pix ** 2, 1))
    return xs, ys, start, kdir


# ---------------------------------------------------------------------------
# Primary pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RayEmissionConfig:
    """Flags of run_ray_tracing_emission (reference CLI table
    README.md:91-114); the JAX config minus its TPU-only fields
    (TPU_ONLY_FIELDS)."""
    n_pix: int = 64
    x_fov: float = 1.44
    freq_hz: float = 75e6
    grid_n: int = 128
    grid_extent: float = 3.0
    z_observer: float = 3.0
    dt: float = 6e-3
    n_steps: int = 5000
    record_stride: int = 10
    s_input_on: bool = False
    nfreq: int = 1
    freq0: float | None = None
    freq_log_step: float = 0.0
    perturb_ratio: float = 2.0     # cross-section ray offset, in |dr|
    phi0_offset: float = 0.0
    mechanism: int = 1 + 4         # free-free + neutral-H (Parms[6])
    theta_deg: float = 90.0        # Parms[4]
    theta_mode: str = "fixed"      # 'fixed' | 'los' (per-voxel theta(B, k))
    gaunt: str = "dulk"            # 'dulk' (reference parity) | 'exact'
    s_mode: str = "cumulative"     # GPU-reference S; 'per_step': CPU's
    seg_records: int = 64          # records per trace segment


# Tiling and debugging knobs of the TPU kernel; none changes the map.
TPU_ONLY_FIELDS = ("rays_per_tile", "tile_factor", "pallas_interpret",
                   "tracer_backend")


def config_from_jax(cfg):
    """The port's RayEmissionConfig for a JAX RayEmissionConfig, field by
    field. The TPU-only fields are dropped; a tracer_backend outside
    ('auto', 'pallas', 'xla') or a field the port does not know is
    refused (the port's one tracer has the XLA tracer's semantics)."""
    values = dataclasses.asdict(cfg)
    backend = values.get("tracer_backend", "auto")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"tracer_backend {backend!r} cannot be honoured")
    for name in TPU_ONLY_FIELDS:
        values.pop(name, None)
    known = {f.name for f in dataclasses.fields(RayEmissionConfig)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise ValueError(f"fields the port cannot honour: {unknown}")
    return RayEmissionConfig(**values)


def run_ray_tracing_emission(model_path=None, config: RayEmissionConfig = None,
                             cubes=None, out_path=None, save_plots=False,
                             verbose=True, mesh=None, consider_beam=False,
                             beam_fwhm=0.2, patch_nan=False, timestep=0,
                             device="cuda", timings=None, **overrides):
    """Full resample -> trace -> transfer pipeline on `device`.

    Either model_path (a MAS directory) or precomputed `cubes` must be
    given: the dict of prepare_cubes or of the JAX call (omega_pe, ne, te,
    b and, for theta_mode='los', the bvec triple), each a tensor, a numpy
    array or another array-like, which cubes_from_numpy brings to float32
    tensors on `device`. Returns the
    reference's result dict: emission_cube (N, N, Nf) T_b in K,
    emission_polVI_cube, frequencies_Hz, x_coords/y_coords in meters
    (resample_with_ray_tracing.py:533-541), and "_sampled": with
    save_plots a one-column LosSamples of the inspection pixel's ray,
    else None. save_plots (with out_path) writes the map and center-pixel
    pngs; consider_beam/beam_fwhm convolve the map plot with a Gaussian
    beam (resample_with_ray_tracing.py:618-639); patch_nan fills the
    pixels that came out non-finite with nearest-finite-neighbour means
    (raytracingGRFF/util.py:6-77).

    A dict passed as `timings` makes the call record its spans in a
    recording of its own (utils/profiling.recording, nested in the active
    one if there is one) and receives their seconds, summed by name, and
    the segment count ("segments"). The stages, on the device clock (CUDA
    events on a card): "resample" (the cubes, "read" and "upload"
    included), "trace" ("trace_inputs", the stacked kernel cubes and the
    start state, included), "transfer", "finish". On the host clock:
    "read" (the HDF4 reads), "upload" (the copies to the device), "rays"
    (the ray starts) and, with out_path, "write" (the .npz, deflated on
    the host's cores by utils/npz.savez_compressed), with the write's
    deflate jobs ("write_chunks") and the threads that ran them
    ("write_threads"). While torch.profiler records, each segment's
    records are also counted as the record fold takes them ("fold_counts":
    [stepped from, taken] a segment, ops/transfer_fold.fold_counts, a
    launch of its own before the fold in a device span of its own,
    "count", outside "transfer"), on the device, read after the stages'
    synchronize; untraced maps count nothing.

    With `mesh` (a parallel.mesh.RayMesh, one per rank) the map runs on
    mesh.device, which a conflicting `device` may not contradict: each
    rank builds the cubes, traces its ray shard through the trace kernel
    and folds it into an (n_local, nf_local) carry over its frequency
    block; one all_gather of the fluxes then gives every rank the whole
    map, as the JAX call returns global arrays. Only rank 0 writes
    out_path and the plots. Its timings add the all_gather's seconds
    ("gather"), the ray shards' live steps and their straggler factor.
    """
    if mesh is not None:
        if not isinstance(mesh, RayMesh):
            raise TypeError(f"mesh must be a parallel.mesh.RayMesh, got "
                            f"{type(mesh).__name__}")
        asked = torch.device(device)
        if asked.type != mesh.device.type or asked.index not in (
                None, mesh.device.index):
            raise ValueError(f"device {device} conflicts with the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    cfg = config or RayEmissionConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    check_s_mode(cfg.s_mode)
    if cfg.theta_mode not in ("fixed", "los"):
        raise ValueError(f"theta_mode must be 'fixed' or 'los', "
                         f"got {cfg.theta_mode!r}")
    device = torch.device(device)

    def log(msg):
        if verbose:
            print(msg)

    recorder = (profiling.recording(device) if timings is not None
                else contextlib.nullcontext())
    with recorder as rec, profiling.span("map", clock=None):
        need_bvec = cfg.theta_mode == "los"
        grid = UniformGrid.cube(cfg.grid_extent, cfg.grid_n)
        with profiling.span("resample", "device"):
            if cubes is None:
                cubes = prepare_cubes(MASModel(model_path, timestep=timestep),
                                      grid, cfg.phi0_offset, verbose=verbose,
                                      keep_bvec=need_bvec, device=device)
            else:
                cubes = cubes_from_numpy(cubes, device)
        if need_bvec and "bvec" not in cubes:
            raise ValueError(
                "theta_mode='los' needs B-vector cubes: pass cubes from "
                "prepare_cubes(..., keep_bvec=True) or a model_path")

        with profiling.span("rays"):
            xs, ys, start, kdir = image_ray_starts(cfg.n_pix, cfg.x_fov,
                                                   cfg.z_observer)
        log(f"Ray tracing {start.shape[0]} rays ({cfg.n_steps} steps, "
            f"stride {cfg.record_stride}) on {device}...")
        freq0 = cfg.freq0 if cfg.freq0 is not None else cfg.freq_hz
        frequencies_hz = log_spaced_freqs(freq0, cfg.nfreq, cfg.freq_log_step)
        pixel_size_cm = (2 * cfg.x_fov) / cfg.n_pix * R_SUN_CM
        pixel_area_cm2 = pixel_size_cm * pixel_size_cm

        stats = {} if mesh is not None else None
        fold_counts = None
        if rec is not None and torch.autograd._profiler_enabled():
            plan, _ = segment_plan(cfg.n_steps, cfg.record_stride,
                                   cfg.seg_records)
            fold_counts = torch.zeros((len(plan), 2), dtype=torch.int64,
                                      device=device)
        flux_o, flux_x, n_segments, center_los = _streamed_trace_transfer(
            cubes, grid, cfg, start, kdir, frequencies_hz, pixel_area_cm2,
            device, collect_center=save_plots, mesh=mesh, stats=stats,
            fold_counts=fold_counts)

        with profiling.span("finish", "device"):
            freqs = torch.as_tensor(frequencies_hz, dtype=torch.float32,
                                    device=device)
            intensity = flux_o + flux_x
            pol_vi = (flux_o - flux_x) / (intensity + 1e-30)
            tb = tb_from_sfu(intensity, freqs, pixel_area_cm2)
            failed = ~torch.isfinite(tb)        # before the sanitisation
            tb = torch.nan_to_num(tb, nan=0.0, posinf=0.0, neginf=0.0)
            shape = (cfg.n_pix, cfg.n_pix, cfg.nfreq)
            emission_cube = tb.cpu().numpy().astype(np.float64).reshape(shape)
            pol_cube = pol_vi.cpu().numpy().astype(np.float64).reshape(shape)
            failed = failed.cpu().numpy().reshape(shape)
        if patch_nan:
            # only the non-finite pixels: exact zeros can be far-off-limb
            # lines of sight that never meet the cube
            from .utils.nanpatch import patch_nan_emission_map
            emission_cube[failed] = np.nan
            emission_cube = patch_nan_emission_map(emission_cube)
            pol_cube[failed] = np.nan
            pol_cube = patch_nan_emission_map(pol_cube)

        result = {
            "emission_cube": emission_cube,
            "emission_polVI_cube": pol_cube,
            "frequencies_Hz": np.asarray(frequencies_hz),
            "x_coords": xs * R_SUN_M,
            "y_coords": ys * R_SUN_M,
        }
        writer = mesh is None or mesh.rank == 0
        written = {}
        if out_path and writer:
            with profiling.span("write"):
                chunks, threads = npz.savez_compressed(out_path, **result)
            written = {"write_chunks": chunks, "write_threads": threads}
            log(f"Saved {out_path}")
        result["_sampled"] = center_los
        if save_plots and out_path and writer:
            from .utils.plotting import (save_center_pixel_plot,
                                         save_emission_plot)
            save_emission_plot(result, cfg.n_pix, cfg.x_fov, out_path,
                               consider_beam=consider_beam,
                               beam_fwhm=beam_fwhm, device=device)
            save_center_pixel_plot(center_los, cfg.n_pix, out_path,
                                   p_index=0)
        if rec is not None:
            timings.update(rec.totals(), segments=n_segments, **written,
                           **(stats or {}))
            if fold_counts is not None:
                timings["fold_counts"] = fold_counts.tolist()
    return result


def _center_los(rows, start, with_cos):
    """A one-column LosSamples of one ray from its (n_records, 8) record
    rows, with the validity and ds of the streamed transfer; cos_theta
    (row 7) only with_cos."""
    rows = rows[:, :, None]
    pos = rows[:, 0:3].transpose(1, 2)
    valid, ds = valid_and_ds(
        pos, rows[:, 3], torch.as_tensor(start, device=rows.device)[None],
        usable=torch.isfinite(rows[:, 7]) if with_cos else None)
    return LosSamples(ne=rows[:, 4], te=rows[:, 5], b=rows[:, 6], ds=ds,
                      valid_mask=valid, s=rows[:, 3],
                      cos_theta=rows[:, 7] if with_cos else None)


def _streamed_trace_transfer(cubes, grid, cfg, start, kdir, frequencies_hz,
                             pixel_area_cm2, device, collect_center=False,
                             mesh=None, stats=None, fold_counts=None):
    """Stream trace segments into the transfer carry on the device: one
    ops/transfer_fold.fold_records call a segment (the JAX package's
    stream_seg, pipeline.py:377-396). Per record: a record is valid
    where its position and S are finite and S > 0; ds is the distance from
    the ray's last valid position in cm; with s_input_on the per-voxel
    source area is S times the pixel area; with theta_mode='los' row 7's
    cos(theta) sets the per-voxel theta, and a record without one (the
    step at which a ray leaving the cube froze: k is NaN, S not yet 0) is
    invalid too. The JAX pipeline keeps that record, and its NaN angle
    makes the voxel evanescent in both modes, which zeroes the pixel.
    Returns (flux_o, flux_x) as
    (n_rays, Nf) float32 tensors, the number of segments and, with
    collect_center, a one-column LosSamples of the reference's inspection
    pixel (resample_with_ray_tracing.py:552-604), else None.

    With `mesh`, the carry holds this rank's ray shard and frequency block
    (pipeline.py:421-429 of the JAX package); one all_gather of both
    fluxes, and one of the inspection ray's records from the rank that
    traced it, end the call on every rank, and `stats` receives the
    trace's shard statistics (iter_trace_segments).

    `fold_counts`, an (n_segments, 2) int64 tensor on `device`, receives
    in row k what segment k's fold did (transfer_fold.fold_counts)."""
    n_rays, nf = start.shape[0], len(frequencies_hz)
    p_center = inspection_pixel_index(cfg.n_pix)
    local_start, local_freqs, p_local = start, frequencies_hz, p_center
    collect_here = collect_center
    if mesh is not None:
        local_start = shard_rays(start, mesh)
        local_freqs = shard_freqs(np.asarray(frequencies_hz), mesh)
        owner = p_center % mesh.shape[0]      # ray shard of the pixel
        p_local = p_center // mesh.shape[0]
        collect_here = collect_center and mesh.ray_index == owner
    freqs = torch.as_tensor(local_freqs, dtype=torch.float32, device=device)
    theta_los = cfg.theta_mode == "los"
    carry = transfer_carry_init(local_start.shape[0], freqs.shape[0], device)
    prev = torch.as_tensor(local_start, device=device).contiguous()
    center_rows = []
    n_segments = 0
    segments = iter_trace_segments(
        cubes["omega_pe"], cubes["ne"], cubes["te"], cubes["b"], grid,
        cfg.freq_hz, start, kdir, cfg.dt, cfg.n_steps, cfg.record_stride,
        trace_crosssections=True, perturb_ratio=cfg.perturb_ratio,
        seg_records=cfg.seg_records,
        bvec=cubes.get("bvec") if theta_los else None, s_mode=cfg.s_mode,
        mesh=mesh, stats=stats)
    while True:
        with profiling.span("trace", "device"):
            recs = next(segments, None)
        if recs is None:
            break
        n_segments += 1
        if fold_counts is not None:
            # a span of its own, outside "transfer": what the fold will do
            with profiling.span("count", "device"):
                transfer_fold.fold_counts(recs, prev,
                                          fold_counts[n_segments - 1],
                                          theta_los)
        with profiling.span("transfer", "device"):
            if collect_here:
                # a copy, so the segment's record block is not kept alive
                center_rows.append(recs[:, :, p_local].clone())
            carry, prev = transfer_fold.fold_records(
                recs, carry, prev, freqs, pixel_area_cm2, cfg.theta_deg,
                cfg.mechanism, gaunt=cfg.gaunt, s_on=cfg.s_input_on,
                theta_los=theta_los)
    flux_o, flux_x = carry[0], carry[1]
    rows = torch.cat(center_rows) if collect_here else None
    if mesh is not None:
        with profiling.span("gather", "device"):
            both = gather_rays(torch.stack([flux_o, flux_x], dim=1), mesh,
                               n_rays, nf)
            flux_o, flux_x = both[:, 0], both[:, 1]
            if collect_center:
                if rows is None:
                    n_rec = -(-cfg.n_steps // cfg.record_stride)
                    rows = torch.zeros((n_rec, 8), device=device)
                rows = all_gather(rows, mesh)[owner * mesh.shape[1]]
    center_los = None
    if collect_center:
        center_los = _center_los(rows, start[p_center], theta_los)
    return flux_o, flux_x, n_segments, center_los


# ---------------------------------------------------------------------------
# Straight-LOS baseline pipeline
# ---------------------------------------------------------------------------

def resample_mas_los(model_path, n_pix=128, x_range=(-1.44, 1.44),
                     y_range=(-1.44, 1.44), n_z=400, dz0=3e-4,
                     variable_spacing_z=True, z_range=None,
                     phi0_offset=24.0, out_path=None, verbose=True,
                     timestep=0, device="cuda"):
    """Straight-LOS resampling of the MAS model (no refraction), sampled
    on `device`.

    Each pixel's LOS starts at the sphere surface (on disk) or just behind
    the limb plane (off disk) and marches toward the observer along +z on
    the irregular z grid; coordinates use cart_to_sph(x, -z, y, phi0)
    (script/resampling_MAS_LOS.py:216-271). The (n_pix, n_pix, n_z)
    coordinate block is built on the device. Returns the LOS_data dict of
    float64 numpy: Ne_LOS/Te_LOS/B_LOS (NaN where r < 1), ds_LOS in cm,
    x/y/z_coords in meters.

    Spans (utils/profiling), named apart from the ray-traced map's so that
    a recording around both keeps each map's own: "los_read" (the HDF4
    reads) and "los_scene_upload" (the scene's copy to the device) on the
    host clock; "los_sample" (the coordinate block, the one sampler
    launch, the masks and casts) on the device clock; "los_download" (the
    samples' copy to the host and the host-built ds) and, with out_path,
    "los_write" on the host clock.
    """
    if variable_spacing_z:
        z_rsun, dz = variable_z_grid(n_z, dz0)
    else:
        z_rsun, dz = linear_z_grid(n_z, z_range or (0.0, 4.0))

    with profiling.span("los_read"):
        model = MASModel(model_path, timestep=timestep)
        names = ("rho", model.temperature_variable(), "br", "bt", "bp")
        variables = [model[v] for v in names]
    with profiling.span("los_scene_upload"):
        arrays = scene_arrays(variables, device)

    xs = np.linspace(x_range[0], x_range[1], n_pix)
    ys = np.linspace(y_range[0], y_range[1], n_pix)
    X, Y = np.meshgrid(xs, ys)                   # X[i,j]=xs[j], Y[i,j]=ys[i]
    rho_sq = X ** 2 + Y ** 2
    z_start = np.where(
        rho_sq < 1.0,
        np.sqrt(np.maximum(1.0 - rho_sq, 0.0)) - 1e-6 / R_SUN_M,
        -np.sqrt(np.maximum(rho_sq - 1.0, 0.0)) - 1e-6 / R_SUN_M,
    )

    if verbose:
        print(f"Sampling LOS grid {n_pix}x{n_pix}x{n_z} on {device}...")
    f32, f64 = torch.float32, torch.float64
    with profiling.span("los_sample", "device"):
        Z = (torch.as_tensor(z_start, dtype=f64, device=device)[:, :, None]
             + torch.as_tensor(z_rsun, dtype=f64, device=device)[None, None,
                                                                  :]
             ).to(f32)
        Xb = torch.as_tensor(X, dtype=f32, device=device)[:, :, None].expand(
            Z.shape)
        Yb = torch.as_tensor(Y, dtype=f32, device=device)[:, :, None].expand(
            Z.shape)
        r, colat, lon = image_xyz_to_mas_sph(Xb, Yb, Z, phi0_offset)
        valid = r >= 0.9999999
        samples = resample.sample_sph_many(
            arrays,
            *(q.contiguous() for q in torch.broadcast_tensors(r, colat, lon)))

        def sample(v):
            return torch.where(valid, v, math.nan).to(f64)

        ne = sample(samples[0])
        te = sample(samples[1])
        b = torch.sqrt(sum(sample(v) ** 2 for v in samples[2:]))
    with profiling.span("los_download"):
        ne, te, b = (t.cpu().numpy() for t in (ne, te, b))
        ds = np.broadcast_to(dz[None, None, :] * R_SUN_CM, ne.shape).copy()

    if (np.isfinite(ne).sum() == 0 and np.isfinite(te).sum() == 0
            and np.isfinite(b).sum() == 0):
        raise RuntimeError(
            "All sampled LOS values are NaN. Check --dz0 units (R_sun); "
            "common mistake is 7e4 vs 7e-4.")

    result = {
        "Ne_LOS": ne, "Te_LOS": te, "B_LOS": b, "ds_LOS": ds,
        "x_coords": xs * R_SUN_M, "y_coords": ys * R_SUN_M,
        "z_coords": z_rsun * R_SUN_M,
    }
    if out_path:
        with profiling.span("los_write"):
            npz.savez_compressed(out_path, **result)
        if verbose:
            print(f"LOS data saved to {out_path}")
    return result


def synthetic_ff(los_data, freq0, nfreq, freq_log_step, out_path=None,
                 mechanism=1 + 4, verbose=True, device="cuda"):
    """GRFF imaging of LOS data (the straight-LOS baseline) on `device`.

    los_data: the resample_mas_los dict or the path of its .npz. The
    voxels go to the transfer step-major, (n_z, n_pix^2), with ds NaN -> 0
    and te NaN -> 1e4 K; a voxel is valid where ne, te and b are all
    finite. Returns the emission dict (synthetic_FF_map_single_thread.py:
    108-312); out_path gets ".npz" appended unless it ends with it.

    Spans (utils/profiling): "los_upload" (the host-built validity and the
    voxel arrays' copies to the device) on the host clock, "los_transfer"
    (get_mw_slice, one voxel-fold launch) and "los_finish" (T_b and V/I
    with the fluxes' copy to the host) on the device clock, and with
    out_path "los_write" on the host clock. While counting
    (profiling.counting) it adds, in a device span of its own
    ("los_count", outside "los_transfer"), the voxels flagged valid
    ("los_flagged") and those the fold takes ("los_taken": flagged, with
    finite float32 ne, te, b and ds, ds > 0), which the data decide.
    """
    if isinstance(los_data, (str, Path)):
        los_data = dict(np.load(los_data))
    ne = los_data["Ne_LOS"]
    te = los_data["Te_LOS"]
    b = los_data["B_LOS"]
    ds = los_data["ds_LOS"]
    x_coords = los_data["x_coords"]
    y_coords = los_data["y_coords"]

    n_pix = ne.shape[0]
    n_z = ne.shape[2]

    pixel_size_cm = (x_coords[1] - x_coords[0]) / R_SUN_M * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm
    frequencies_hz = log_spaced_freqs(freq0, nfreq, freq_log_step)

    def to_zpix(a, nan=0.0):
        a = torch.as_tensor(np.asarray(a, np.float64), device=device)
        return torch.nan_to_num(a, nan=nan).reshape(n_pix * n_pix, n_z).T

    if verbose:
        print(f"GRFF transfer: {n_pix}x{n_pix} pixels, {n_z} voxels, "
              f"{nfreq} freqs on {device}...")
    with profiling.span("los_upload"):
        valid = ~(np.isnan(ne) | np.isnan(te) | np.isnan(b))
        voxels = (to_zpix(ds), to_zpix(te, nan=1e4), to_zpix(ne), to_zpix(b),
                  to_zpix(valid) > 0.5)
    if profiling.counting():
        with profiling.span("los_count", "device"):
            *fields, flagged = voxels
            ds32, *rest = (a.to(torch.float32) for a in fields)
            taken = flagged & torch.isfinite(ds32) & (ds32 > 0)
            for a in rest:
                taken &= torch.isfinite(a)
            profiling.count("los_flagged", flagged.sum())
            profiling.count("los_taken", taken.sum())
    with profiling.span("los_transfer", "device"):
        res = get_mw_slice(*voxels, freq0, nfreq, freq_log_step,
                           pixel_area_cm2, mechanism=mechanism, device=device)

    with profiling.span("los_finish", "device"):
        intensity = (res.flux_o + res.flux_x).cpu().numpy().astype(
            np.float64)
        pol = ((res.flux_o - res.flux_x).cpu().numpy().astype(np.float64)
               / (intensity + 1e-30))
        tb = tb_from_sfu(intensity, np.asarray(frequencies_hz)[None, :],
                         pixel_area_cm2)
    result = {
        "emission_cube": tb.reshape(n_pix, n_pix, nfreq),
        "emission_polVI_cube": pol.reshape(n_pix, n_pix, nfreq),
        "frequencies_Hz": np.asarray(frequencies_hz),
        "x_coords": x_coords, "y_coords": y_coords,
    }
    if out_path:
        with profiling.span("los_write"):
            npz.savez_compressed(out_path, **result)
        if verbose:
            print(f"Saved {out_path}")
    return result
