"""The port's numpy utilities and the CLIs built on them against the JAX
package's: FITS files written by one package and read by the other,
multi-band observations (the inputs of tests/test_obs_spectrum.py), the
ROI spectra of obs_spectrum, compare_tb_spectra and compare_obs, the SDO
context figure, utils/profiling.py on the CPU, and grff/native.py's
build of the native GET_MW library."""

import json
import shutil

import numpy as np
import pytest
import torch

from raytracinggrff_tpu.cli import compare_obs as jcmp_obs
from raytracinggrff_tpu.cli import compare_tb_spectra as jcmp_tb
from raytracinggrff_tpu.cli import obs_spectrum as jobs_spec
from raytracinggrff_tpu.constants import R_SUN_M
from raytracinggrff_tpu.grff import native as jnative
from raytracinggrff_tpu.utils import fits as jfits
from raytracinggrff_tpu.utils.obs import load_multiband_observation as jload
from raytracinggrff_tpu_torch.cli import compare_obs as pcmp_obs
from raytracinggrff_tpu_torch.cli import compare_tb_spectra as pcmp_tb
from raytracinggrff_tpu_torch.cli import obs_spectrum as pobs_spec
from raytracinggrff_tpu_torch.cli import sdo_context as psdo
from raytracinggrff_tpu_torch.grff import native as pnative
from raytracinggrff_tpu_torch.grff import transfer as ptr
from raytracinggrff_tpu_torch.utils import fits as pfits
from raytracinggrff_tpu_torch.utils.obs import load_multiband_observation
from raytracinggrff_tpu_torch.utils.profiling import StageTimer, device_trace

torch.set_num_threads(1)


def _obs_cube(nb=4, n=32):
    """Synthetic disk cube of tests/test_obs_spectrum.py: band b is a
    uniform (b+1)*1e5 K disk."""
    img = np.zeros((nb, n, n))
    x = np.linspace(-2, 2, n)
    X, Y = np.meshgrid(x, x)
    disk = (X ** 2 + Y ** 2) < 1.0
    for b in range(nb):
        img[b][disk] = (b + 1) * 1e5
    return img, 20e6 * (1 + np.arange(nb)), x


def _plate_cards(x):
    rsun = 945.0
    dx = (x[1] - x[0]) * rsun
    crpix = 1.0 - x[0] * rsun / dx
    return {"CDELT1": dx, "CDELT2": dx, "CRPIX1": crpix, "CRPIX2": crpix,
            "RSUN_OBS": rsun}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fits_written_by_one_package_reads_in_the_other(tmp_path, writer):
    """The two writers make the same bytes, and each reader reads the
    other's file: the image with its cards, and the bintable."""
    img, freqs, x = _obs_cube()
    w, r = (jfits, pfits) if writer == "jax" else (pfits, jfits)
    path = tmp_path / "obs.fits"
    kw = dict(header_cards=dict(_plate_cards(x), OBSERVER="ovro"),
              table_columns={"cfreqs": freqs, "width": freqs / 10})
    w.write_fits_image(path, img[None], **kw)
    r.write_fits_image(tmp_path / "twin.fits", img[None], **kw)
    assert path.read_bytes() == (tmp_path / "twin.fits").read_bytes()
    data, header = r.read_fits_image(path)
    np.testing.assert_array_equal(data[0], img.astype(np.float32))
    assert header["OBSERVER"] == "ovro" and header["NAXIS"] == 4
    cols = r.read_fits_bintable(path)
    np.testing.assert_array_equal(cols["cfreqs"], freqs)
    np.testing.assert_array_equal(cols["width"], freqs / 10)
    w.write_fits_image(tmp_path / "band.fits", img[1])
    for a, b in zip(pfits.load_observation_map(tmp_path / "band.fits"),
                    jfits.load_observation_map(tmp_path / "band.fits")):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def _assert_obs_equal(a, b):
    for name in ("img_k", "freqs_hz", "x_rsun", "y_rsun"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("container", ["fits", "npz", "glob", "hdf5"])
def test_multiband_observation_equals_jax(tmp_path, container):
    img, freqs, x = _obs_cube()
    if container == "fits":
        path = tmp_path / "obs.fits"
        pfits.write_fits_image(path, img[None],
                               header_cards=_plate_cards(x),
                               table_columns={"cfreqs": freqs})
    elif container == "npz":
        path = tmp_path / "obs.npz"
        np.savez(path, img_k=img, freqs_hz=freqs, x_coords=x * R_SUN_M,
                 y_coords=x * R_SUN_M)
    elif container == "glob":
        for b in range(4)[::-1]:
            pfits.write_fits_image(tmp_path / f"band{b}.fits", img[b],
                                   dict(_plate_cards(x), RESTFRQ=freqs[b]))
        path = str(tmp_path / "band*.fits")
    else:
        h5py = pytest.importorskip("h5py")
        path = tmp_path / "obs.h5"
        with h5py.File(path, "w") as f:
            ds = f.create_dataset("image_I", data=img)
            for k, v in _plate_cards(x).items():
                ds.attrs[k] = v
            f.create_dataset("cfreqs", data=freqs)
    obs = load_multiband_observation(path)
    _assert_obs_equal(obs, jload(path))
    np.testing.assert_allclose(obs.freqs_hz, freqs)
    np.testing.assert_allclose(obs.img_k, img)
    np.testing.assert_allclose(obs.x_rsun, x, atol=1e-6)


def _write_model_sweep(out_dir, freqs_hz, n=24):
    """Sweep outputs whose disk brightness varies over the map."""
    x = np.linspace(-2, 2, n)
    X, Y = np.meshgrid(x, x)
    disk = (X ** 2 + Y ** 2) < 1.0
    for i, f in enumerate(freqs_hz):
        tb = np.zeros((n, n, 1))
        tb[disk, 0] = 4e5 * (i + 1) * (1.2 + X[disk] - 0.3 * Y[disk])
        np.savez(out_dir / f"raytrace_{i:02d}_{f / 1e6:08.3f}MHz.npz",
                 emission_cube=tb, frequencies_Hz=np.array([f]),
                 x_coords=x * R_SUN_M, y_coords=x * R_SUN_M)


def test_roi_spectra_equal_jax(tmp_path):
    """obs_spectrum's ROI spectra (model and observed, every default ROI
    and one given), compare_tb_spectra's model spectrum and the two CLIs'
    outputs equal the JAX ones on the same maps."""
    freqs = np.array([20e6, 40e6, 60e6, 80e6])
    _write_model_sweep(tmp_path, freqs)
    img, ofreqs, x = _obs_cube()
    obs_path = tmp_path / "obs.npz"
    np.savez(obs_path, img_k=img, freqs_hz=ofreqs, x_rsun=x, y_rsun=x)
    rois = pobs_spec.DEFAULT_ROIS + [("disk", -0.3, 0.3, -0.3, 0.3)]
    assert pobs_spec.DEFAULT_ROIS == jobs_spec.DEFAULT_ROIS
    rows_p = pobs_spec.collect_model_maps(tmp_path)
    rows_j = jobs_spec.collect_model_maps(tmp_path)
    spec_p = pobs_spec.roi_spectra(rows_p, load_multiband_observation(
        obs_path), rois)
    spec_j = jobs_spec.roi_spectra(rows_j, jload(obs_path), rois)
    for a, b in zip(spec_p, spec_j):
        assert a["name"] == b["name"]
        for key in ("freq_model_hz", "tb_model_k", "freq_obs_hz",
                    "tb_obs_k", "err_obs_k"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert np.isfinite(spec_p[2]["tb_obs_k"][1:]).all()

    np.testing.assert_array_equal(pcmp_tb.load_model_spectrum(tmp_path, 0.8),
                                  jcmp_tb.load_model_spectrum(tmp_path, 0.8))
    outs = {}
    for side, spec_mod, tb_mod in (("port", pobs_spec, pcmp_tb),
                                   ("jax", jobs_spec, jcmp_tb)):
        png = tmp_path / f"{side}_spec.png"
        assert spec_mod.main(["-m", str(tmp_path), "-b", str(obs_path),
                              "--roi=-0.3,0.3,-0.3,0.3,disk", "-o",
                              str(png)]) == 0
        outs[side] = dict(np.load(png.with_suffix(".npz")))
        assert tb_mod.main(["--mfs-dir", str(tmp_path), "-o",
                            str(tmp_path / f"{side}_tb.png")]) == 0
        assert (tmp_path / f"{side}_tb.png").exists()
    assert outs["port"].keys() == outs["jax"].keys()
    for key in outs["port"]:
        np.testing.assert_array_equal(outs["port"][key], outs["jax"][key])


def test_compare_obs_equals_jax(tmp_path, capsys):
    """compare_obs on a model map and a FITS observation of another size:
    the port prints the JAX ROI statistics and writes its figure."""
    _write_model_sweep(tmp_path, [150e6], n=32)
    model = next(tmp_path.glob("raytrace_*.npz"))
    img, _, _ = _obs_cube(nb=1, n=48)
    pfits.write_fits_image(tmp_path / "obs.fits", img[0] * 1.5)
    lines = {}
    for side, mod in (("port", pcmp_obs), ("jax", jcmp_obs)):
        out = tmp_path / f"{side}.png"
        assert mod.main(["-m", str(model), "-b",
                         str(tmp_path / "obs.fits"), "-o", str(out)]) == 0
        assert out.exists()
        lines[side] = capsys.readouterr().out.splitlines()[0]
    assert lines["port"] == lines["jax"] and "ratio" in lines["port"]


def test_sdo_context_figure(tmp_path):
    """Panels from FITS and npz through the port's FITS reader, the JAX
    reader's arrays, and a written three-panel figure."""
    rng = np.random.default_rng(0)
    panels = {}
    for name in ("aia304", "aia171"):
        panels[name] = rng.random((20, 24))
        pfits.write_fits_image(tmp_path / f"{name}.fits", panels[name])
    panels["hmi"] = rng.normal(0, 100, (20, 24))
    np.savez(tmp_path / "hmi.npz", map=panels["hmi"])
    paths = {"aia304": tmp_path / "aia304.fits",
             "aia171": tmp_path / "aia171.fits",
             "hmi": tmp_path / "hmi.npz"}
    for name, path in paths.items():
        a = psdo.load_panel(path)
        np.testing.assert_array_equal(
            a, np.asarray(jfits.load_observation_map(path)[0], np.float64))
        np.testing.assert_allclose(a, panels[name], rtol=1e-6)
    out = tmp_path / "ctx.png"
    psdo.main(["--aia304", str(paths["aia304"]), "--aia171",
               str(paths["aia171"]), "--hmi", str(paths["hmi"]), "-d",
               "2025-06-08T20:00", "-o", str(out)])
    assert out.exists()


def test_stage_timer_and_device_trace_on_cpu(tmp_path):
    timer = StageTimer(device="cpu")
    for _ in range(2):
        with timer.stage("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.stage("sum"):
        torch.arange(10).sum()
    assert timer.counts == {"matmul": 2, "sum": 1}
    assert all(v >= 0 for v in timer.totals.values())
    report = timer.report().splitlines()
    assert len(report) == 2 and "x2" in report[[r.split()[0] for r in
                                                report].index("matmul")]
    assert StageTimer().device is None
    with device_trace(tmp_path / "trace") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert any("mm" in e.name for e in prof.events())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_native_build_matches_jax_loader(tmp_path, monkeypatch):
    """grff/native.py builds the library into the directory it is given
    (never native/), reuses it while the source is older, and its
    get_mw_native equals the JAX loader's on the same library, bit for
    bit, and the port's get_mw to 2e-3 (tests/test_native_grff.py's
    tolerance)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    build = tmp_path / "_build"
    lib = pnative.build_native_lib(build)
    assert lib == build / "GRFF_DEM_Transfer.so" and lib.exists()
    mtime = lib.stat().st_mtime_ns
    assert pnative.build_native_lib(build) == lib
    assert lib.stat().st_mtime_ns == mtime
    assert pnative.BUILD_DIR.name == "_build"
    assert pnative.BUILD_DIR.parent.name == "raytracinggrff_tpu_torch"

    nz, nf = 12, 3
    rng = np.random.default_rng(2)
    parms = np.zeros((15, nz), order="F")
    parms[0] = rng.uniform(5e8, 5e9, nz)
    parms[1] = 10 ** rng.uniform(5.5, 6.3, nz)
    parms[2] = 10 ** rng.uniform(7.5, 9.0, nz)
    parms[3] = rng.uniform(1.0, 20.0, nz)
    parms[4], parms[6], parms[7] = 90.0, 5, 30
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([(0.045 * 6.957e10) ** 2, 1.0e8, 0.1])
    rl = pnative.get_mw_native(lparms, rparms, parms,
                               fn=pnative.init_get_mw(lib))
    jinit = jnative.init_get_mw
    monkeypatch.setattr(jnative, "init_get_mw",
                        lambda libname=None: jinit(lib))
    np.testing.assert_array_equal(rl, jnative.get_mw_native(lparms, rparms,
                                                            parms))
    port = ptr.get_mw(lparms, rparms, parms, device="cpu")
    for row in (5, 6):
        np.testing.assert_allclose(port[row], rl[row], rtol=2e-3)
    with pytest.raises(ValueError, match="DEM mode"):
        pnative.get_mw_native(np.array([nz, nf, 4, 0, 0], np.int32), rparms,
                              parms, t=np.ones(3), dem=np.ones(4),
                              fn=pnative.init_get_mw(lib))
