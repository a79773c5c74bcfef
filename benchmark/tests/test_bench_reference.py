"""The plain reference against the program at a tiny size on the CPU,
where the program runs its plain versions: every value equal."""

import numpy as np
import torch

from benchmark.gen.mas import mas_arrays, write_mas_dir
from benchmark.reference import map as ref_map
from benchmark.reference import scene as ref_scene
from benchmark.reference import presets as ref_presets
from benchmark.tests.tiny import TINY_MAP, TINY_SCENE
from raytracinggrff_tpu_torch.cli import tb_spectra
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.mas.model import MASModel, synthetic_mas_model
from raytracinggrff_tpu_torch.pipeline import (image_ray_starts,
                                               prepare_cubes,
                                               run_ray_tracing_emission)
from raytracinggrff_tpu_torch.tracer_segments import trace_rays_segments

SCENE = dict(TINY_SCENE, r_max=6.0, b0_gauss=2.5, timestep=2,
             modulation_amplitude=[0.2, 0.4],
             modulation_phase_rad=[0.0, 6.283185307179586])
RUN = dict(x_fov=1.44, freq_hz=75e6, grid_extent=3.0, z_observer=3.0,
           record_stride=10, s_input_on=True, nfreq=3, freq0=75e6,
           freq_log_step=0.05, perturb_ratio=2.0, phi0_offset=30.0,
           mechanism=5, theta_deg=90.0, **TINY_MAP)


def scene(tmp_path, seed=9):
    arrays, mesh = mas_arrays(SCENE, seed)
    return arrays, mesh, write_mas_dir(tmp_path / "m", arrays, mesh, 2)


def test_the_program_model_lies_inside_the_seeded_ranges(tmp_path):
    """With a = 0.3 and psi = 0 the generator writes the program's own
    synthetic model, bit for bit."""
    import benchmark.gen.mas as gen
    arrays, mesh = gen.mas_arrays(SCENE, 1)
    amp, psi = gen.draw_structure(SCENE, 1)
    assert 0.2 <= amp <= 0.4 and 0.0 <= psi < 2 * np.pi
    orig = gen.draw_structure
    gen.draw_structure = lambda scene, seed: (0.3, 0.0)
    try:
        arrays, mesh = gen.mas_arrays(SCENE, 1)
    finally:
        gen.draw_structure = orig
    gen.write_mas_dir(tmp_path / "a", arrays, mesh, 2)
    synthetic_mas_model(tmp_path / "b", nphi=16, ntheta=12, nr=14)
    for name in ("rho", "t", "br", "bt", "bp"):
        a = MASModel(tmp_path / "a")[name]
        b = MASModel(tmp_path / "b")[name]
        assert np.array_equal(a.data, b.data) and np.array_equal(a.r, b.r)


def test_seeds_change_structure_not_sizes():
    a, mesh_a = mas_arrays(SCENE, 2 ** 33 + 1)
    b, mesh_b = mas_arrays(SCENE, 2 ** 33 + 1)
    c, mesh_c = mas_arrays(SCENE, 4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["rho"], c["rho"])
    assert all(a[k].shape == c[k].shape for k in a)
    assert all(np.array_equal(x, y) for x, y in zip(mesh_a, mesh_c))


def test_scene_cubes_equal_prepare_cubes(tmp_path):
    arrays, mesh, path = scene(tmp_path)
    grid = UniformGrid.cube(3.0, 24)
    want = prepare_cubes(MASModel(path), grid, 30.0, verbose=False,
                         device="cpu")
    got = ref_scene.scene_cubes(arrays, mesh, ref_scene.Grid.cube(3.0, 24),
                                30.0, "cpu", torch.float32)
    assert ref_scene.Grid.cube(3.0, 24).axes()[0].tolist() == \
        grid.axes()[0].tolist()
    for k in ("omega_pe", "ne", "te", "b"):
        assert torch.equal(got[k], want[k]), k


def test_trace_records_equal_the_program(tmp_path):
    arrays, mesh, path = scene(tmp_path)
    grid = UniformGrid.cube(3.0, 24)
    cubes = prepare_cubes(MASModel(path), grid, 30.0, verbose=False,
                          device="cpu")
    _, _, start, kdir = image_ray_starts(8, 1.44, 3.0)
    want = trace_rays_segments(cubes["omega_pe"], cubes["ne"], cubes["te"],
                               cubes["b"], grid, 75e6, start, kdir, 2e-2,
                               200, 10, True, 2.0, 8)
    rays = np.array([0, 5, 17, 40, 63])
    got = ref_map.trace_pixels(arrays, mesh, dict(RUN, grid_n=24), rays,
                               "cpu")
    assert np.array_equal(got[:, 0:3].numpy().transpose(0, 2, 1),
                          want.r_record[:, rays])
    assert np.array_equal(got[:, 3].numpy(), want.s_record[:, rays])
    assert np.array_equal(got[:, 4].numpy(), want.ne[:, rays])


def test_map_pixels_equal_the_program_map(tmp_path):
    arrays, mesh, path = scene(tmp_path)
    res = run_ray_tracing_emission(model_path=str(path), verbose=False,
                                   device="cpu", **RUN)
    pixels = np.array([0, 9, 27, 36, 63])
    tb, vi = ref_map.map_pixels(arrays, mesh, dict(RUN, n_pix=8), pixels,
                                "cpu")
    assert np.array_equal(tb, res["emission_cube"].reshape(64, 3)[pixels])
    assert np.array_equal(vi,
                          res["emission_polVI_cube"].reshape(64, 3)[pixels])


def test_sweep_presets_equal_the_program():
    for f in ref_presets.sweep_frequencies(30.0, 800.0, 30):
        assert ref_presets.sweep_preset(f) == tb_spectra.quantize_params(
            tb_spectra.select_params(float(f)))
        assert ref_presets.sweep_preset(f, True) == tb_spectra.select_params(
            float(f))
    assert np.array_equal(ref_presets.sweep_frequencies(30.0, 800.0, 30),
                          tb_spectra.sweep_frequencies())
