"""raytracinggrff_tpu_torch: the ray-traced solar radio emission map on
PyTorch and CUDA (NVIDIA H100).

The port of raytracinggrff_tpu: MAS model resampling, the refractive ray
trace with cross-sections as a hand-written CUDA kernel
(csrc/trace_segment.cu), the two-mode free-free and gyroresonance transfer
to brightness temperature, the straight-LOS pipeline, the GET_MW entry
points and multi-device runs over a torch.distributed mesh (parallel/). It
imports torch and numpy, never jax, and never the JAX package. Every device
choice is explicit: the entry points default to "cuda" and run on the CPU
only when asked.

The public names are those of raytracinggrff_tpu, with its
reference-compatible aliases (raytracingGRFF/__init__.py exports and the
legacy names of gpu_raytrace.py:762-780), plus the port's own. Three names
of the JAX package belong to its TPU segment loop (tracer_pallas.py) and
have no name here; TPU_ONLY_NAMES maps each to its counterpart in the
port, or to None where the port needs none.
"""

from .constants import C_R, R_SUN_CM, R_SUN_M
from .coords import cart_to_sph, image_xyz_to_mas_sph, sph_to_cart
from .grff.transfer import get_mw, get_mw_slice, grff_transfer, tb_from_sfu
from .grids import UniformGrid, linear_z_grid, variable_z_grid
from .mas.model import (MASModel, MASVariable, load_mas_var,
                        resample_var_to_cube, synthetic_mas_model)
from .parallel import (RayMesh, gather_rays, make_mesh, replicate,
                       shard_freqs, shard_rays, spawn)
from .pipeline import (RayEmissionConfig, config_from_jax, cubes_from_numpy,
                       image_ray_starts, prepare_cubes, resample_mas_los,
                       run_ray_tracing_emission, synthetic_ff)
from .sampler import (LosSamples, pack_model_table, sample_model_with_rays,
                      sample_model_with_rays_arrays)
from .tracer import (TraceResult, pack_trace_table, trace_rays,
                     trace_rays_from_cube)
from .tracer_segments import (SegmentTraceResult, iter_trace_segments,
                              trace_rays_segments)
from .utils.nanpatch import patch_nan_emission_map

# Reference-compatible aliases, as raytracinggrff_tpu/__init__.py:65-75
ray_trace = trace_rays_from_cube
trace_ray = trace_rays_from_cube
load_mas_var_filtered = load_mas_var
resample_to_xyz_cube = resample_var_to_cube
trace_los_cpu = sample_model_with_rays_arrays
trace_los_gpu = sample_model_with_rays_arrays
trace_los_gpu_cupy = sample_model_with_rays_arrays
trace_los_dispatch = sample_model_with_rays_arrays
ray_trace_gpu = trace_rays_from_cube

# The JAX package's names of its TPU segment loop and their counterparts. The
# port has no tail traces: a GPU thread follows its ray to the end of every
# segment (tracer_segments.py), so no ray is left to finish afterwards.
TPU_ONLY_NAMES = {
    "trace_rays_pallas": "trace_rays_segments",
    "PallasTraceResult": "SegmentTraceResult",
    "iter_tail_traces": None,
}

__all__ = [
    "C_R", "R_SUN_CM", "R_SUN_M",
    "cart_to_sph", "sph_to_cart", "image_xyz_to_mas_sph",
    "UniformGrid", "variable_z_grid", "linear_z_grid",
    "TraceResult", "trace_rays", "trace_rays_from_cube", "pack_trace_table",
    "SegmentTraceResult", "trace_rays_segments", "iter_trace_segments",
    "LosSamples", "sample_model_with_rays", "sample_model_with_rays_arrays",
    "pack_model_table",
    "get_mw", "get_mw_slice", "grff_transfer", "tb_from_sfu",
    "MASModel", "MASVariable", "synthetic_mas_model", "load_mas_var",
    "resample_var_to_cube",
    "RayEmissionConfig", "run_ray_tracing_emission", "resample_mas_los",
    "synthetic_ff", "prepare_cubes", "config_from_jax", "cubes_from_numpy",
    "image_ray_starts",
    "patch_nan_emission_map",
    "RayMesh", "make_mesh", "shard_rays", "gather_rays", "shard_freqs",
    "replicate", "spawn",
    "ray_trace", "trace_ray", "load_mas_var_filtered", "resample_to_xyz_cube",
    "trace_los_cpu", "trace_los_gpu", "trace_los_gpu_cupy",
    "trace_los_dispatch", "ray_trace_gpu",
    "TPU_ONLY_NAMES",
]

__version__ = "0.1.0"
