"""The compare_800mhz cell: faults planted in the straight-LOS half, which
the map faults do not reach, read `correct` false; the cell's readers read
None without the program's spans and counts; the LOS rooflines' frozen
arithmetic gives chip_smoke's bounds; the driver refuses a configuration
that compare_frequency would not run, and a program whose
compare_frequency takes no preset fails at set-up. At a tiny size on the
CPU, where the program runs its plain versions."""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
import raytracinggrff_tpu_torch.ops.resample as resample
import raytracinggrff_tpu_torch.ops.transfer_fold as transfer_fold
import raytracinggrff_tpu_torch.pipeline as pipeline
from benchmark.drivers import compare as driver
from benchmark.harness import Run, reader, run_cell
from benchmark.tests.test_bench_imports import top_level_modules
from benchmark.tests.tiny import tiny_cell
from benchmark.yardstick import los_roofline
from raytracinggrff_tpu_torch.grff.transfer import transfer_carry_init

CELL = "compare_800mhz"
sample_sph_many = resample.sample_sph_many
fold_voxels = transfer_fold.fold_voxels
variable_z_grid = pipeline.variable_z_grid
SPAN_READERS = ("ray_ms.compare", "los_sample_ms.compare",
                "los_host_ms.compare", "los_transfer_ms.compare")
ROOFLINES = ("voxel_fold_roofline.compare", "sample_roofline.compare")
COUNTS = {"los_flagged": 70000, "los_taken": 69000}
# the per-layer metrics of the map cells that read the compare cell's
# ray-traced half, from the keys its timings carry as a map's do
MAP_READERS = ("trace_ms.map", "resample_ms.map", "transfer_ms.map",
               "finish_ms.map", "read_ms.map", "write_ms.map")


def samples_high(monkeypatch):
    """The sampler's values are 2% high where they are produced."""
    monkeypatch.setattr(resample, "sample_sph_many",
                        lambda *a: [v * 1.02 for v in sample_sph_many(*a)])


def fold_returns_its_carry(monkeypatch):
    """The voxel fold hands back the carry it was given (zeros when given
    none)."""
    def broken(ds, te, ne, b, valid, freqs, *a, carry=None, **k):
        if carry is not None:
            return tuple(carry)
        return transfer_carry_init(ds.shape[1], freqs.shape[0], ds.device)
    monkeypatch.setattr(transfer_fold, "fold_voxels", broken)


def ds_linear(monkeypatch):
    """ds is built on a linear z grid of the same depth in place of the
    irregular one; the sample points stay where they were."""
    def broken(n_z, dz0):
        z, dz = variable_z_grid(n_z, dz0)
        return z, np.full_like(dz, z[-1] / n_z)
    monkeypatch.setattr(pipeline, "variable_z_grid", broken)


@pytest.mark.parametrize("fault", [samples_high, fold_returns_its_carry,
                                   ds_linear], ids=lambda f: f.__name__)
def test_los_fault_reads_incorrect(fault, tmp_path, monkeypatch):
    cell = tiny_cell(CELL)
    with torch.inference_mode():
        fault(monkeypatch)
        result = run_cell(cell, 13, 0.01, 0, "cpu", tmp_path)
    assert result["correct"] is False, result["check"]
    assert max(result["check"][k]["value"]
               for k in ("los_tb_gap", "los_vi_gap")) > 0
    assert result["check"]["tb_gap"]["value"] == 0


def test_reference_and_yardstick_load_nothing_of_the_program():
    loaded = top_level_modules(["benchmark.reference.los",
                                "benchmark.yardstick.los_roofline"])
    assert not loaded & {"raytracinggrff_tpu_torch", "raytracinggrff_tpu",
                         "jax", "jaxlib"}
    loaded = top_level_modules(["benchmark.drivers.compare"])
    assert "raytracinggrff_tpu_torch" in loaded
    assert not loaded & {"raytracinggrff_tpu", "jax", "jaxlib"}


def run_of(units, kernel_us=None):
    run = Run(tiny_cell(CELL), 1.0, 1, "cpu")
    run.units = units
    run.kernel_us = dict(kernel_us or {})
    return run


def unit(**timings):
    return {"wall": 0.5, "nfreq": 1, "timings": timings}


def test_span_readers_average_over_units():
    run = run_of([unit(ray=0.1, los_sample=0.002, los_download=0.05,
                       los_upload=0.07, los_transfer=0.003),
                  unit(ray=0.3, los_sample=0.004, los_download=0.03,
                       los_upload=0.05, los_transfer=0.005)])
    assert reader("ray_ms.compare")(run) == pytest.approx(200.0)
    assert reader("los_sample_ms.compare")(run) == pytest.approx(3.0)
    assert reader("los_host_ms.compare")(run) == pytest.approx(100.0)
    assert reader("los_transfer_ms.compare")(run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", SPAN_READERS
                         + ("voxel_fold_roofline.compare",))
def test_readers_read_none_without_the_program_spans_or_counts(name):
    """A program without the spans and counts (the ray-traced map's stages
    alone, as the parent's compare_frequency gives them), a window with no
    unit, or a trace without the kernel reads None, never 0."""
    stages = dict(resample=0.05, trace=0.08, transfer=0.001, finish=0.005)
    kernels = {"void (anonymous namespace)::fold_voxels_kernel<1>": 600.0,
               "(anonymous namespace)::sample_sph_kernel": 200.0}
    assert reader(name)(run_of([unit(**stages)], kernels)) is None
    assert reader(name)(run_of([], kernels)) is None
    if name.endswith("roofline.compare"):
        assert reader(name)(run_of([unit(**COUNTS)])) is None
    if name == "los_host_ms.compare":
        assert reader(name)(run_of([unit(los_download=0.1)])) is None


def test_sample_roofline_reads_none_without_units_or_the_kernel():
    """The sampler's counts come from the configuration; without a
    completed unit or without the sampler's kernel in the trace the share
    is None, never 0."""
    kernels = {"(anonymous namespace)::sample_sph_kernel": 200.0}
    name = "sample_roofline.compare"
    assert reader(name)(run_of([], kernels)) is None
    assert reader(name)(run_of([unit()], {"fold_records_kernel": 1.0})) \
        is None
    assert reader(name)(run_of([unit()], kernels)) > 0


def test_rooflines_from_counts_and_kernel_times():
    """With counts and the kernels' device time, each share lies in (0,
    100] and is the frozen bound over the kernel time; kernels of other
    names are not counted."""
    kernels = {"void (anonymous namespace)::fold_voxels_kernel<1>(...)":
               600.0, "(anonymous namespace)::sample_sph_kernel(...)": 200.0,
               "fold_records_kernel<4>": 1e6, "resample_cube_kernel": 1e6}
    run = run_of([unit(**COUNTS), unit(**COUNTS)], kernels)
    fold = reader("voxel_fold_roofline.compare")(run)
    samp = reader("sample_roofline.compare")(run)
    assert 0.0 < fold <= 100.0 and 0.0 < samp <= 100.0
    n_pix = driver.preset(run.cell)[0]["n_pix"] ** 2
    n_z = run.cell.config["los"]["n_z"]
    want = 2 * los_roofline.fold_voxels_bound_ms(
        n_pix * n_z, COUNTS["los_flagged"], COUNTS["los_taken"], n_pix, 1,
        5)[0]
    assert fold == pytest.approx(100.0 * want / 0.6)
    want = 2 * los_roofline.sample_bound_ms(
        n_pix * n_z, 5 * n_pix * n_z,
        5 * 17 * 12 * 14 + 17 + 12 + 14)[0]
    assert samp == pytest.approx(100.0 * want / 0.2)


def test_sample_counts_are_the_programs_sampler_launch(tmp_path):
    """The configuration's counts equal the points, the values and the
    distinct arrays and axes of the one sampler launch that the program
    makes on the cell's scene (chip_smoke.sample_bound's own count)."""
    cell = tiny_cell(CELL)
    run, los, p = driver.preset(cell)
    _, _, model_dir = driver.write_scene(cell, 5, tmp_path)
    seen = []

    def spy(variables, *queries):
        seen.append((variables, queries[0].numel()))
        return sample_sph_many(variables, *queries)

    with pytest.MonkeyPatch.context() as m, torch.inference_mode():
        m.setattr(resample, "sample_sph_many", spy)
        pipeline.resample_mas_los(
            str(model_dir), n_pix=run["n_pix"],
            x_range=(-run["x_fov"], run["x_fov"]),
            y_range=(-run["x_fov"], run["x_fov"]), n_z=p["n_z"],
            dz0=p["dz0"], phi0_offset=run["phi0_offset"], verbose=False,
            device="cpu")
    [(variables, n)] = seen
    distinct = {t.data_ptr(): t.numel() for v in variables for t in v}
    assert los_roofline.sample_counts(run["n_pix"], p["n_z"],
                                      cell.config["scene"]) == (
        n, n * len(variables), sum(distinct.values()))
    assert los_roofline.sample_bound_ms(
        *los_roofline.sample_counts(run["n_pix"], p["n_z"],
                                    cell.config["scene"])) == \
        chip_smoke.sample_bound(variables, n)


def test_map_readers_read_the_ray_traced_half(tmp_path):
    """A traced tiny run of the cell: the map cells' span and stage
    readers that list the cell read its ray-traced map's own keys, which
    the LOS half's spans leave as they are (each LOS span is named
    los_...)."""
    listed = {m["name"] for m in tiny_cell(CELL).per_layer}
    assert set(MAP_READERS) <= listed
    cell = tiny_cell(CELL)
    with torch.inference_mode():
        result = run_cell(cell, 7, 0.01, 1, "cpu", tmp_path)
    assert result["correct"] is True, result["check"]
    got = result["metrics"]
    for name in MAP_READERS + SPAN_READERS:
        assert got[name]["value"] > 0, name
    assert got["ray_ms.compare"]["value"] > sum(
        got[f"{k}_ms.map"]["value"] for k in ("resample", "trace",
                                              "transfer", "finish"))


def test_sample_bound_matches_chip_smoke():
    """On scenes of shared and staggered axes, the bound from the counts
    the program takes is chip_smoke's bound from the tensors."""
    assert los_roofline.SAMPLE_FLOPS == chip_smoke.SAMPLE_FLOPS
    phi, theta, r = torch.rand(17), torch.rand(12), torch.rand(14)
    shared = [(torch.rand(17, 12, 14), phi, theta, r) for _ in range(5)]
    staggered = shared[:3] + [(torch.rand(16, 12, 14), torch.rand(16),
                               theta, r)]
    for variables, n in ((shared, 6_553_600), (staggered, 1000),
                         (shared[:1], 18_022_400)):
        distinct = {t.data_ptr(): t.numel() for v in variables for t in v}
        got = los_roofline.sample_bound_ms(n, n * len(variables),
                                           sum(distinct.values()))
        assert got == chip_smoke.sample_bound(variables, n)


@pytest.mark.parametrize("nf, mechanism", [(1, 5), (4, 5), (3, 1)])
def test_fold_voxels_bound_matches_chip_smoke(nf, mechanism):
    """On voxels with flags off, fields not finite and ds = 0, the bound
    from the counts is chip_smoke's bound from the arrays."""
    g = torch.Generator().manual_seed(nf)
    nz, n = 50, 300
    ds = torch.rand((nz, n), generator=g) * 1e8
    te, ne, b = (torch.rand((nz, n), generator=g) for _ in range(3))
    valid = torch.rand((nz, n), generator=g) > 0.2
    ne[3, :40] = float("nan")
    ds[5, 10:90] = 0.0
    freqs = torch.linspace(3e8, 8e8, nf)
    want = chip_smoke.fold_voxels_bound(ds, te, ne, b, valid, freqs, 1e18,
                                        mechanism=mechanism)
    taken = (valid & torch.isfinite(ne) & torch.isfinite(te)
             & torch.isfinite(b) & torch.isfinite(ds) & (ds > 0))
    assert int(taken.sum()) == want[2] < int(valid.sum())
    got = los_roofline.fold_voxels_bound_ms(valid.numel(), int(valid.sum()),
                                            int(taken.sum()), n, nf,
                                            mechanism)
    assert got == want[:2]


def test_driver_refuses_what_compare_frequency_does_not_run():
    for section, key, value in (("map", "mechanism", 7),
                                ("map", "s_input_on", True),
                                ("map", "freq0", 7.5e8),
                                ("los", "nfreq", 3),
                                ("los", "variable_spacing_z", False)):
        cell = tiny_cell(CELL)
        cell.config[section][key] = value
        with pytest.raises(ValueError, match=key):
            driver.preset(cell)
    run, los, p = driver.preset(tiny_cell(CELL))
    assert p == dict(grid_n=24, grid_extent=1.45, z_observer=1.44, dt=2e-2,
                     n_steps=200, record_stride=5, seg_records=8, dz0=9e-5,
                     n_z=1100)
    assert (run["n_pix"], run["x_fov"]) == (8, 1.44)


def test_a_program_without_preset_fails_at_setup(tmp_path, monkeypatch):
    """The parent's compare_frequency takes no preset: the run raises in
    the driver's set-up, before any unit, and does not hang."""
    params = inspect.signature(driver.compare_frequency).parameters
    assert "preset" in params

    def parent(model_path, freq, n_pix=128, x_fov=2.8, grid_n=256,
               grid_extent=4.0, z_observer=4.0, phi0_offset=0.0,
               highband=False, ray_npz=None, los_npz=None, verbose=True,
               device="cuda", timings=None):
        raise AssertionError("not reached")

    monkeypatch.setattr(driver, "compare_frequency", parent)
    with pytest.raises(TypeError, match="preset"):
        run_cell(tiny_cell(CELL), 3, 0.01, 0, "cpu", tmp_path)
