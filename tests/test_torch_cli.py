"""The port's CLIs that drive the device (tb_spectra, compare_s_input,
demo_rays, plot_model_slices, bench) against their JAX counterparts, at
small sizes on the CPU: the same model files and flags through both
packages, the outputs compared at the bars of tests/test_torch_pipeline.py
(lit T_b to rtol 5e-3, V/I to atol 1e-4) and of
tests/test_pallas_trace.py:52-65 (positions to 2e-4)."""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu.cli import bench as jbench
from raytracinggrff_tpu.cli import compare_s_input as jcmp
from raytracinggrff_tpu.cli import plot_model_slices as jslices
from raytracinggrff_tpu.cli import tb_spectra as jtb
from raytracinggrff_tpu.mas.model import MASModel as JaxModel
from raytracinggrff_tpu.mas.model import synthetic_mas_model
from raytracinggrff_tpu_torch.cli import bench as pbench
from raytracinggrff_tpu_torch.cli import compare_s_input as pcmp
from raytracinggrff_tpu_torch.cli import demo_rays as pdemo
from raytracinggrff_tpu_torch.cli import plot_model_slices as pslices
from raytracinggrff_tpu_torch.cli import tb_spectra as ptb
from raytracinggrff_tpu_torch.mas.model import MASModel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corona(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "corona"
    synthetic_mas_model(path, nphi=36, ntheta=25, nr=40)
    return path


def _assert_maps_agree(port, ref, min_lit=10, floor=1e4):
    """Lit values (> floor K in both) to rtol 5e-3 and V/I to atol 1e-4;
    a value lit in one map is lit in the other."""
    a, b = ref["emission_cube"], port["emission_cube"]
    assert np.array_equal(a > floor, b > floor)
    lit = a > floor
    assert lit.sum() > min_lit
    np.testing.assert_allclose(b[lit], a[lit], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"][lit],
                               ref["emission_polVI_cube"][lit], atol=1e-4)


@pytest.mark.parametrize("lattice", [True, False])
def test_sweep_presets_equal_jax(lattice):
    """select_params, and quantize_params on top with the lattice, give
    the JAX sweep's presets at all 30 default frequencies."""
    freqs = ptb.sweep_frequencies()
    np.testing.assert_array_equal(
        freqs, np.logspace(np.log10(30.0), np.log10(800.0), 30) * 1e6)
    grids = set()
    for f in freqs:
        p, j = ptb.select_params(float(f)), jtb.select_params(float(f))
        if lattice:
            p, j = ptb.quantize_params(p), jtb.quantize_params(j)
        assert p == j, f
        grids.add(p["grid_n"])
    if lattice:
        assert grids == {256, 384, 512, 576}


def _tiny_preset(freq_hz):
    """Two cube sets for the two sweep frequencies: the sweep drops the
    first before it resamples the second."""
    return {"grid_n": 24 if freq_hz < 120e6 else 28, "grid_extent": 2.5,
            "z_observer": 2.5, "x_fov": 1.3, "dt": 1e-2, "n_steps": 300,
            "record_stride": 10}


def test_two_frequency_sweep_matches_jax(corona, tmp_path, monkeypatch):
    """Both CLIs' sweeps with a tiny preset: the npz maps agree, the
    manifests list the same files, and run_sweep's timings name each
    map's preset, records and stages. A resumed port sweep keeps the
    complete manifest."""
    monkeypatch.setattr(jtb, "select_params", _tiny_preset)
    monkeypatch.setattr(ptb, "select_params", _tiny_preset)
    flags = ["-m", str(corona), "-n", "8", "--fmin-mhz", "100",
             "--fmax-mhz", "150", "--n-freq", "2", "--exact-presets",
             "--s-input-on", "-q"]
    jtb.main(flags + ["--out-dir", str(tmp_path / "jax")])
    ptb.main(flags + ["--out-dir", str(tmp_path / "port"), "--device",
                      "cpu"])
    names = []
    for side in ("jax", "port"):
        text = (tmp_path / side / "TbSpectra_manifest.txt").read_text()
        names.append(text.replace(str(tmp_path / side), "OUT"))
    assert names[0] == names[1] and len(names[0].splitlines()) == 3
    for npz in sorted((tmp_path / "jax").glob("raytrace_*.npz")):
        port = dict(np.load(tmp_path / "port" / npz.name))
        ref = dict(np.load(npz))
        _assert_maps_agree(port, ref)
        np.testing.assert_array_equal(port["x_coords"], ref["x_coords"])
        png = npz.name.replace("raytrace_", "Tb_map_").replace(".npz",
                                                               ".png")
        assert (tmp_path / "port" / png).exists()

    timings = []
    rows = ptb.run_sweep(corona, ptb.sweep_frequencies(100, 150, 2),
                         tmp_path / "port", n_pix=8, s_input_on=True,
                         exact_presets=True, start_from_idx=1,
                         device="cpu", timings=timings, verbose=False)
    assert [r["idx"] for r in rows] == [0, 1]
    (entry,) = timings
    assert entry["grid_n"] == 28 and entry["records"] == 30
    assert entry["segments"] == 1 and entry["peak_bytes"] is None
    assert {"resample", "trace", "transfer", "finish"} <= set(entry)
    with pytest.raises(ValueError, match="start-from-idx"):
        ptb.run_sweep(corona, [100e6], tmp_path, start_from_idx=1,
                      device="cpu")


def test_compare_s_input_matches_jax(corona, tmp_path, capsys):
    """At 300 steps the rays of the CLI's 60 MHz default stop in the
    corona, so the maps hold 1e2-1e3 K; both maps agree above 100 K."""
    flags = ["-m", str(corona), "--N-pix", "8", "--grid-n", "24",
             "--n-steps", "300", "--no-plot", "-q"]
    jcmp.main(flags + ["-o", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    pcmp.main(flags + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    for name in ("ray_tracing_compare_s_on.npz",
                 "ray_tracing_compare_s_off.npz"):
        _assert_maps_agree(dict(np.load(tmp_path / "port" / name)),
                           dict(np.load(tmp_path / "jax" / name)),
                           floor=100.0)
    heads = [line.split("=")[0] for line in port_out.splitlines()]
    assert heads == [line.split("=")[0] for line in jax_out.splitlines()]
    assert "--- Ratio (S_on / S_off) on valid pixels ---" in port_out


def test_demo_rays_match_jax_trace(corona, tmp_path):
    """The port's limb rays (kernel path, cross-sections off, plain
    version on the CPU) against the JAX tracer on the JAX resample of the
    same variable, on a 24^3 cube."""
    import jax.numpy as jnp

    from raytracinggrff_tpu.constants import FPE_COEF
    from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
    from raytracinggrff_tpu.mas.model import resample_var_to_cube
    from raytracinggrff_tpu.tracer import pack_trace_table, trace_rays
    flags = ["-m", str(corona), "--grid-n", "24", "--n-steps", "300",
             "--device", "cpu", "-q"]
    args = pdemo.build_parser().parse_args(flags)
    omega_pe, grid, r_record = pdemo.trace_demo_rays(args)

    g = np.linspace(-4.0, 4.0, 24)
    jgrid = JaxGrid.from_arrays(g, g, g)
    rho = resample_var_to_cube(JaxModel(corona)["rho"], jgrid,
                               phi0_offset_deg=24.0, fill_nan=0.0)
    wpe = jnp.nan_to_num(FPE_COEF * jnp.sqrt(jnp.maximum(rho, 0.0))
                         * 2 * np.pi)
    np.testing.assert_allclose(omega_pe.numpy(), np.asarray(wpe),
                               rtol=1e-5, atol=1e-5 * float(wpe.max()))
    z = np.linspace(-1.5, 1.5, 18)
    start = np.column_stack([np.full(18, 3.999), np.zeros(18),
                             z]).astype(np.float32)
    kdir = np.tile(np.float32([[-1, 0, 0]]), (18, 1))
    ref = trace_rays(pack_trace_table(wpe, jgrid), jgrid, 75e6, start,
                     kdir, 10e-3, 300, 10)
    assert r_record.shape == (30, 18, 3)
    np.testing.assert_allclose(r_record, np.asarray(ref.r_record),
                               rtol=2e-4, atol=2e-4)
    assert np.ptp(r_record[:, :, 0]) > 1.0   # the rays moved

    out = tmp_path / "rays.png"
    assert pdemo.main(flags + ["--out-plot", str(out)]) == 0
    assert out.exists()


def test_sample_plane_and_polar_cuts_match_jax(corona, tmp_path):
    port = pslices.sample_plane(MASModel(corona), n_pix=32, extent=2.0,
                                phi0_offset=30.0, device="cpu")
    ref = jslices.sample_plane(JaxModel(corona), n_pix=32, extent=2.0,
                               phi0_offset=30.0)
    for key in ("ne", "te", "b"):
        assert port[key].shape == (32, 32)
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-5,
                                   err_msg=key)
    assert port["extent"] == ref["extent"]
    cuts_p = pslices.polar_cuts(MASModel(corona)["rho"])
    cuts_j = jslices.polar_cuts(JaxModel(corona)["rho"])
    for key in ("eq", "mer"):
        for a, b in zip(cuts_p[key], cuts_j[key]):
            np.testing.assert_allclose(a, b, rtol=1e-12)
    assert cuts_p["phi_cut_deg"] == cuts_j["phi_cut_deg"]
    for extra in ([], ["--polar"]):
        out = tmp_path / f"slices{len(extra)}.png"
        assert pslices.main(["-m", str(corona), "--n-pix", "16", "--device",
                             "cpu", "-o", str(out)] + extra) == 0
        assert out.exists()


def test_bench_case_equals_jax_and_main_prints_both_lines(capsys):
    for a, b in zip(pbench.make_case(4, 8, 16, seed=3),
                    jbench.make_case(4, 8, 16, seed=3)):
        np.testing.assert_array_equal(a, b)
    pbench.main(["--n-pix", "4", "--n-steps", "8", "--grid-n", "16",
                 "--repeat", "1", "--trace-steps", "20", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("LOS sampling best: ")
    assert lines[0].endswith(" samples/s)")
    assert lines[1].startswith("Trace best: ")
    assert lines[1].endswith("ray-steps/s, cross-sections on)")
