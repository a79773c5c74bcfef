"""The PyTorch port's package surface: it imports without jax and without
the JAX package, and its constants, grid axes, ray starts and config
match the JAX package's."""

import dataclasses
import importlib
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracinggrff_tpu.constants as jconst
from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu.pipeline import RayEmissionConfig as JaxConfig
from raytracinggrff_tpu.pipeline import image_ray_starts as jax_starts
import raytracinggrff_tpu_torch.constants as pconst
import raytracinggrff_tpu_torch.mas.model as pmodel
import raytracinggrff_tpu_torch.pipeline as ppipeline
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.pipeline import (TPU_ONLY_FIELDS,
                                               RayEmissionConfig,
                                               config_from_jax,
                                               cubes_from_numpy,
                                               image_ray_starts)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "raytracinggrff_tpu_torch"
CARD_SCRIPTS = ("chip_smoke.py", "profile_slice.py")
# the port's CLIs beside the JAX package's 13 (pyproject.toml), and those
# of them that run on a torch device
ALL_CLIS = ("ray_tracing_emission", "resample_los", "synthetic_ff",
            "tb_spectra", "compare_los_raytracing", "compare_s_input",
            "bench", "demo_rays", "plot_model_slices", "compare_tb_spectra",
            "compare_obs", "obs_spectrum", "sdo_context")
DEVICE_CLIS = ("ray_tracing_emission", "resample_los", "synthetic_ff",
               "compare_los_raytracing", "tb_spectra", "compare_s_input",
               "bench", "demo_rays", "plot_model_slices")
JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax\b|raytracinggrff_tpu\b(?!_torch))",
    re.MULTILINE)


def test_import_leaves_jax_out():
    modules = sorted(
        "raytracinggrff_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    assert set(modules) >= {
        "raytracinggrff_tpu_torch." + m for m in (
            "sampler", "harness", "utils.nanpatch", "utils.beam", "utils.plotting",
            "utils.fits", "utils.obs", "utils.profiling", "grff.native",
            "grff.reference", "parallel.mesh", "parallel.launch",
            "parallel.dryrun", "cli.resample_los", "cli.synthetic_ff",
            "cli.compare_los_raytracing", *(f"cli.{c}" for c in ALL_CLIS))}
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'raytracinggrff_tpu' "
            "or m.startswith('raytracinggrff_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PKG.parent, timeout=120)


def test_sources_never_import_jax_or_the_jax_package():
    files = list(PKG.rglob("*.py"))
    assert len(files) >= 41
    for path in files:
        assert not JAX_IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_script_imports_no_jax_and_needs_cuda(script):
    """The scripts that run on the card import no jax; without a CUDA
    device they exit 1 and print nothing to stdout."""
    assert not JAX_IMPORT.search((ROOT / script).read_text())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == "", proc.stderr


@pytest.mark.parametrize("name", ["run_ray_tracing_emission",
                                  "prepare_cubes", "resample_var_to_cube",
                                  "resample_mas_los", "synthetic_ff",
                                  "cli.tb_spectra.run_sweep",
                                  "cli.plot_model_slices.sample_plane",
                                  "tracer.trace_rays_from_cube",
                                  "parallel.launch.spawn",
                                  "parallel.dryrun.dryrun_multichip"])
def test_entry_points_default_to_cuda(name):
    if "." in name:
        mod, name = name.rsplit(".", 1)
        module = importlib.import_module(f"raytracinggrff_tpu_torch.{mod}")
    else:
        module = pmodel if name == "resample_var_to_cube" else ppipeline
    param = inspect.signature(getattr(module, name)).parameters["device"]
    assert param.default == "cuda", name


def test_every_jax_cli_has_a_port():
    """Each of the JAX package's console scripts has a module of the same
    name in the port's cli/."""
    text = (ROOT / "pyproject.toml").read_text()
    jax_clis = set(re.findall(r'"raytracinggrff_tpu\.cli\.(\w+):main"',
                              text))
    assert jax_clis == set(ALL_CLIS)
    for cli in ALL_CLIS:
        assert (PKG / "cli" / f"{cli}.py").exists(), cli


@pytest.mark.parametrize("cli", DEVICE_CLIS)
def test_cli_device_defaults_to_cuda(cli):
    parser = importlib.import_module(
        f"raytracinggrff_tpu_torch.cli.{cli}").build_parser()
    assert parser.get_default("device") == "cuda", cli


def test_constants_equal_jax():
    names = [n for n in dir(pconst) if n.isupper()]
    assert names == [n for n in dir(jconst) if n.isupper()]
    for name in names:
        assert getattr(pconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("name,values", [
    ("freq_to_omega", np.geomspace(30e6, 800e6, 17)),
    ("ne_to_omega_pe", np.geomspace(1e5, 1e10, 23).reshape(23, 1)
     * np.ones((1, 3)))])
def test_constant_functions_equal_jax(name, values):
    """The conversions of constants.py, numpy in and numpy out, equal to
    the JAX package's (rtol 0)."""
    port = getattr(pconst, name)(values)
    ref = getattr(jconst, name)(values)
    assert isinstance(port, np.ndarray) and port.shape == values.shape
    np.testing.assert_array_equal(port, ref)
    assert getattr(pconst, name)(1e8) == getattr(jconst, name)(1e8)


# the JAX package's TPU segment loop and its packers: replaced by
# tracer_segments.py and csrc/trace_segment.cu, not ported by design
TPU_LOOP_MODULES = ("tracer_pallas", "ops.pallas_trace")


def _public_top_level_names(package):
    """{module path relative to the package: its public top-level names
    (functions, classes and assigned names)} by ast."""
    import ast
    out = {}
    for path in package.rglob("*.py"):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
        mod = ".".join(path.relative_to(package).with_suffix("").parts)
        out[mod] = {n for n in names if not n.startswith("_")}
    return out


def test_every_public_top_level_name_has_a_twin():
    """Every public top-level name of every module of the JAX package is
    defined in the port's module of the same path, apart from the TPU
    segment loop's modules."""
    jax_names = _public_top_level_names(ROOT / "raytracinggrff_tpu")
    port_names = _public_top_level_names(PKG)
    assert set(TPU_LOOP_MODULES) <= set(jax_names)
    missing = {mod: sorted(names - port_names.get(mod, set()))
               for mod, names in jax_names.items()
               if mod not in TPU_LOOP_MODULES}
    assert not {m: n for m, n in missing.items() if n}, missing


@pytest.mark.parametrize("extent,n", [(3.0, 128), (2.5, 40), (1.0, 7)])
def test_grid_axes_equal_jax(extent, n):
    g = UniformGrid.cube(extent, n)
    j = JaxGrid.cube(extent, n)
    assert dataclasses.asdict(g) == dataclasses.asdict(j)
    for a, b in zip(g.axes(), j.axes()):
        np.testing.assert_array_equal(a, b)
    assert g.inv_steps == j.inv_steps and g.origin == j.origin


def test_image_ray_starts_equal_jax():
    for a, b in zip(image_ray_starts(16, 1.44, 3.0),
                    jax_starts(16, 1.44, 3.0)):
        np.testing.assert_array_equal(a, b)


def test_config_fields_are_jax_minus_tpu_only():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port = {f.name: f.default for f in dataclasses.fields(RayEmissionConfig)}
    assert set(TPU_ONLY_FIELDS) == {"rays_per_tile", "tile_factor",
                                    "pallas_interpret", "tracer_backend"}
    for name in TPU_ONLY_FIELDS:
        jax_fields.pop(name)
    assert port == jax_fields


def test_config_from_jax_maps_and_refuses():
    jcfg = JaxConfig(n_pix=12, nfreq=3, s_input_on=True, seg_records=9,
                     tracer_backend="xla", rays_per_tile=256)
    cfg = config_from_jax(jcfg)
    assert cfg.n_pix == 12 and cfg.nfreq == 3 and cfg.s_input_on
    assert cfg.seg_records == 9
    with pytest.raises(ValueError, match="cannot be honoured"):
        config_from_jax(dataclasses.replace(jcfg, tracer_backend="mosaic"))


def test_cubes_from_numpy():
    rng = np.random.default_rng(1)
    c = {k: rng.random((3, 4, 5)) for k in ("omega_pe", "ne", "te", "b")}
    c["bvec"] = tuple(rng.random((3, 4, 5)) for _ in range(3))
    t = cubes_from_numpy(c, "cpu")
    assert t["ne"].dtype == torch.float32 and t["ne"].shape == (3, 4, 5)
    np.testing.assert_array_equal(t["bvec"][2].numpy(),
                                  c["bvec"][2].astype(np.float32))
    assert "bvec" not in cubes_from_numpy(
        {k: c[k] for k in ("omega_pe", "ne", "te", "b")}, "cpu")
