"""The plain versions of the scene kernels (ops/resample.py,
ops/los_scans.py) against their JAX twins on the same numpy inputs from a
seed: the cube resample (_resample_cube_jit), the spherical sampler
(_interp_sph), both one variable at a time and over a scene of five
variables on staggered meshes, the ds scan (sampler.los_from_records) and
GET_MW's DEM recurrence (the voxel scan of _grff_transfer_dem_jit), at
rtol 1e-5 with equal NaN and validity masks. On the CPU every wrapper runs
its plain version and counts no launch; a device without a kernel is
refused. The kernels themselves are held to these plain versions on the
card in tests/test_torch_cuda.py."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggrff_tpu import sampler as jsam
from raytracinggrff_tpu.grff import transfer as jtr
from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu.mas import model as jmodel
from raytracinggrff_tpu_torch import sampler as psam
from raytracinggrff_tpu_torch.grff import transfer as ptr
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.mas import model as pmodel
from raytracinggrff_tpu_torch.ops import _build, los_scans, resample

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """One small synthetic MAS model directory, read by both packages."""
    return pmodel.synthetic_mas_model(tmp_path_factory.mktemp("mas") / "m",
                                      nphi=16, ntheta=13, nr=24)


def _close_with_nans(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=RTOL)
    return ok


@pytest.mark.parametrize("var", ["rho", "br"])
@pytest.mark.parametrize("fill", [None, 0.0])
@pytest.mark.parametrize("phi0", [0.0, -140.0])
def test_resample_cube_plain_matches_jax(model, phi0, fill, var):
    """resample_cube_plain on a 19^3 cube (19 is no multiple of the
    16-plane slab, so the last slab is partial) against the JAX
    resample_var_to_cube."""
    grid = UniformGrid.cube(2.5, 19)
    pv = pmodel.MASModel(model)[var]
    axes = [torch.as_tensor(a, dtype=torch.float32) for a in grid.axes()]
    out = resample.resample_cube_plain(*pv.device_arrays("cpu"), *axes,
                                       phi0, fill)
    ref = jmodel.resample_var_to_cube(jmodel.MASModel(model)[var],
                                      JaxGrid.cube(2.5, 19), phi0,
                                      fill_nan=fill)
    assert out.shape == (19, 19, 19)
    ok = _close_with_nans(out.numpy(), ref)
    assert ok.mean() > 0.5
    assert ok.all() == (fill is not None)


def test_sample_sph_plain_matches_jax(model):
    """sample_sph_plain at (40, 50) queries whose phi is one (50,) axis
    that it broadcasts, with NaN, r on both sides of the mesh and phi
    outside [0, 2 pi), against the JAX _interp_sph_jit on the broadcast
    queries."""
    rng = np.random.default_rng(3)
    f32 = np.float32
    r = rng.uniform(0.9, 6.2, (40, 50)).astype(f32)
    colat = rng.uniform(-0.1, np.pi + 0.1, (40, 50)).astype(f32)
    phi = rng.uniform(-7.0, 13.0, 50).astype(f32)
    r[0, :3] = [np.nan, 0.5, 7.0]
    colat[1, 0] = np.nan
    var_p = pmodel.MASModel(model)["t"]
    var_j = jmodel.MASModel(model)["t"]
    out = resample.sample_sph_plain(*var_p.device_arrays("cpu"),
                                    *map(torch.as_tensor, (r, colat, phi)))
    ref = jmodel._interp_sph_jit(
        *var_j.device_arrays(),
        *map(jnp.asarray, (r, colat, np.broadcast_to(phi, r.shape))))
    assert out.shape == (40, 50)
    _close_with_nans(out.numpy(), ref)
    assert np.isnan(out.numpy()[0, :3]).all()


def staggered_scene(seed=7, nphi=12, ntheta=10, nr=14):
    """Five MAS variables as numpy (data, phi, theta, r), a seed-made mesh
    staggered as a MAS run staggers them: rho and t on one mesh, br on the
    r half-steps, bt on the theta half-steps, bp on the phi half-steps (the
    periodic copy padded as MASVariable pads it). The fields are smooth, as
    MAS fields are (a seed-made amplitude and phase each): torch and XLA
    may round a voxel's coordinates one ulp apart, which moves a smooth
    field's sample by far less than the tests' rtol."""
    rng = np.random.default_rng(seed)
    phi = np.sort(rng.uniform(0.0, 2 * np.pi, nphi))
    theta = np.sort(rng.uniform(0.02, np.pi - 0.02, ntheta))
    r = 1.0 + 5.0 * np.sort(rng.uniform(0.0, 1.0, nr)) ** 1.5
    r[0] = 1.0

    def half(a):
        return 0.5 * (a[:-1] + a[1:])

    def padded(p):
        return np.concatenate([p, [p[0] + 2 * np.pi]])

    meshes = [(padded(phi), theta, r), (padded(phi), theta, r),
              (padded(phi), theta, half(r)), (padded(phi), half(theta), r),
              (padded(half(phi)), theta, r)]
    scene = []
    for p, t, rr in meshes:
        amp, shift = rng.uniform(0.1, 0.4), rng.uniform(0.0, np.pi)
        P, T, R = np.meshgrid(p[:-1], t, rr, indexing="ij")
        data = (1.0 + amp * np.cos(2 * P + shift) * np.sin(T) ** 2) / R ** 2
        data = np.concatenate([data, data[:1]], axis=0)
        scene.append(tuple(a.astype(np.float32) for a in (data, p, t, rr)))
    return scene


def _torch_scene(scene):
    """The scene as CPU tensors, the axes that equal an earlier variable's
    shared as one tensor (as mas/model.scene_arrays shares them)."""
    seen = {}
    return [tuple(seen.setdefault((k, a.tobytes()), torch.as_tensor(a))
                  if k else torch.as_tensor(a) for k, a in enumerate(v))
            for v in scene]


@pytest.mark.parametrize("fill", [None, 0.0])
@pytest.mark.parametrize("phi0", [0.0, -140.0])
def test_resample_cubes_plain_matches_jax(phi0, fill):
    """resample_cubes_plain of a staggered five-variable scene onto an 18^3
    cube (its center off the nodes), variable by variable, against the JAX
    _resample_cube_jit of that variable at rtol 1e-5 with equal NaN masks;
    resample_cube (one variable) and resample_cubes equal it there."""
    scene = staggered_scene()
    grid = UniformGrid.cube(2.5, 18)
    axes = [torch.as_tensor(a, dtype=torch.float32) for a in grid.axes()]
    variables = _torch_scene(scene)
    out = resample.resample_cubes_plain(variables, *axes, phi0, fill)
    many = resample.resample_cubes(variables, *axes, phi0, fill)
    assert len(out) == len(many) == 5
    jfill = None if fill is None else (float(fill),)
    for v, (arrays, cube) in enumerate(zip(scene, out)):
        ref = jmodel._resample_cube_jit(*map(jnp.asarray, arrays),
                                        JaxGrid.cube(2.5, 18),
                                        jnp.float32(phi0), jfill)
        assert cube.shape == (18, 18, 18)
        ok = _close_with_nans(cube.numpy(), ref)
        assert ok.mean() > 0.5 and ok.all() == (fill is not None), v
        one = resample.resample_cube(*variables[v], *axes, phi0, fill)
        for got in (one, many[v]):
            assert torch.equal(got.isnan(), cube.isnan())
            assert torch.equal(got.nan_to_num(), cube.nan_to_num())


def test_sample_sph_many_plain_matches_jax():
    """sample_sph_many_plain of the staggered scene at (30, 40) queries
    with NaN, r on both sides of each r axis and phi outside [0, 2 pi),
    variable by variable, against the JAX _interp_sph_jit; sample_sph (one
    variable) and sample_sph_many equal it there."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    q = [rng.uniform(0.9, 6.2, (30, 40)).astype(f32),
         rng.uniform(-0.1, np.pi + 0.1, (30, 40)).astype(f32),
         rng.uniform(-7.0, 13.0, (30, 40)).astype(f32)]
    q[0][0, :3] = [np.nan, 0.5, 7.0]
    q[1][1, 0] = np.nan
    q[2][2, 1] = np.nan
    scene = staggered_scene()
    variables = _torch_scene(scene)
    qt = [torch.as_tensor(a) for a in q]
    out = resample.sample_sph_many_plain(variables, *qt)
    many = resample.sample_sph_many(variables, *qt)
    for v, (arrays, got) in enumerate(zip(scene, out)):
        ref = jmodel._interp_sph_jit(*map(jnp.asarray, arrays),
                                     *map(jnp.asarray, q))
        assert got.shape == (30, 40)
        _close_with_nans(got.numpy(), ref)
        assert np.isnan(got.numpy()[0, :3]).all()
        for other in (resample.sample_sph(*variables[v], *qt), many[v]):
            assert torch.equal(other.isnan(), got.isnan())
            assert torch.equal(other.nan_to_num(), got.nan_to_num())


def test_scene_arrays_share_equal_axes(model):
    """mas/model.scene_arrays uploads an axis once for the variables whose
    axes are equal: the synthetic model's five variables share their three
    axes; a staggered scene shares only its equal ones. Each tuple equals
    MASVariable.device_arrays."""
    m = pmodel.MASModel(model)
    variables = [m[v] for v in ("rho", "t", "br", "bt", "bp")]
    arrays = pmodel.scene_arrays(variables, "cpu")
    for var, got in zip(variables, arrays):
        assert all(torch.equal(a, b)
                   for a, b in zip(got, var.device_arrays("cpu")))
        assert all(got[k] is arrays[0][k] for k in (1, 2, 3))
    staggered = [pmodel.MASVariable(n, d[:-1], p[:-1], t, r, 1.0)
                 for n, (d, p, t, r) in zip("abcde", staggered_scene())]
    arrays = pmodel.scene_arrays(staggered, "cpu")
    shared = [[arrays[v][k] is arrays[0][k] for k in (1, 2, 3)]
              for v in range(5)]
    assert shared == [[True] * 3, [True] * 3, [True, True, False],
                      [True, False, True], [False, True, True]]


def test_sph_params_mirror_the_cuda_struct():
    """ops/_build._SphParams lists the fields of struct SphParams in
    csrc/resample_sph.cu in its order, types and array sizes, with
    MAX_VARS as the source's kMaxVars."""
    src = (Path(_build.CSRC) / "resample_sph.cu").read_text()
    assert int(re.search(r"constexpr int kMaxVars = (\d+);", src).group(1)) \
        == _build.MAX_VARS == resample.MAX_VARS
    body = re.search(r"struct SphParams \{(.*?)\n\};", src, re.S).group(1)
    dims = {"kMaxVars": _build.MAX_VARS, "3": 3}
    fields = []
    types = r"const float\*|float\*|long long|int|float"
    for ctype, names in re.findall(rf"^\s*({types}) ([^;]+);", body, re.M):
        for decl in names.split(","):
            name, *shape = re.findall(r"\w+", decl)
            fields.append((name, ctype.strip(), [dims[d] for d in shape]))
    base = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float, "const float*": ctypes.c_void_p,
            "float*": ctypes.c_void_p}
    want = []
    for name, ct in _build._SphParams._fields_:
        shape = []
        while issubclass(ct, ctypes.Array):
            shape.append(ct._length_)
            ct = ct._type_
        want.append((name, ct, shape))
    assert [(n, base[c], s) for n, c, s in fields] == want


def _records(seed, n_rec=30, n_rays=40):
    """Straight records with a NaN position, NaN and non-positive
    cross-sections, and a `usable` mask."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    start = rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(f32)
    dirs = rng.normal(size=(n_rays, 3)).astype(f32)
    t = (np.arange(1, n_rec + 1, dtype=f32) * 0.02)[:, None, None]
    pos = (start[None] + t * dirs[None]).astype(f32)
    pos[4, 2, 1] = np.nan
    pos[7, :5] = np.inf
    s = rng.uniform(0.5, 2.0, (n_rec, n_rays)).astype(f32)
    s[::5, ::3] = 0.0
    s[::7, ::4] = -1.0
    s[2, 6] = np.nan
    usable = rng.uniform(size=(n_rec, n_rays)) > 0.2
    return pos, s, start, usable


@pytest.mark.parametrize("with_usable", [False, True])
def test_valid_ds_plain_matches_jax(with_usable):
    """valid_ds_plain against the JAX los_from_records scan on the same
    records; with a `usable` mask, against the JAX scan of records whose
    cross-section is NaN where the mask is off (the same validity): valid
    masks equal, ds within rtol 1e-5 and 0 exactly where it is 0."""
    pos, s, start, usable = _records(11)
    valid, ds = los_scans.valid_ds_plain(
        *map(torch.as_tensor, (pos, s, start)),
        usable=torch.as_tensor(usable) if with_usable else None)
    s_j = np.where(usable, s, np.nan) if with_usable else s
    n_rec, n_rays = s.shape
    zeros = np.zeros((n_rec, n_rays), np.float32)
    ref = jsam.los_from_records(pos, s_j, zeros, zeros, zeros, start)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref.valid_mask))
    assert 0 < valid.numpy().mean() < 1
    np.testing.assert_array_equal(ds.numpy() == 0, np.asarray(ref.ds) == 0)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ref.ds), rtol=RTOL)
    # the scan as the sampler runs it
    v2, ds2 = psam.valid_and_ds(
        *map(torch.as_tensor, (pos, s, start)),
        usable=torch.as_tensor(usable) if with_usable else None)
    assert torch.equal(v2, valid) and torch.equal(ds2, ds)


def _jax_dem_scan(tau, src, evan, m):
    """The voxel scan of the JAX package's _grff_transfer_dem_jit
    (raytracinggrff_tpu/grff/transfer.py:427-441) over one mode."""
    def voxel(carry, xs):
        f, t_sum = carry
        tau_k, evan_k, src_k, m_row = xs
        att = jnp.exp(-tau_k)
        emit = -jnp.expm1(-tau_k)
        f = f * att + jnp.where(m_row, src_k * emit, 0.0)
        f = jnp.where(evan_k, 0.0, f)
        t_sum = jnp.where(evan_k, jnp.inf, t_sum + tau_k)
        return (f, t_sum), None

    nf = tau.shape[1]
    (f, t_sum), _ = jax.lax.scan(
        voxel, (jnp.zeros(nf, jnp.float32), jnp.zeros(nf, jnp.float32)),
        (tau, evan, src, jnp.broadcast_to(m[:, None], tau.shape)))
    return np.asarray(f), np.asarray(t_sum)


@pytest.mark.parametrize("nz,nf", [(1, 1), (37, 5), (120, 16)])
def test_dem_scan_plain_matches_jax(nz, nf):
    """dem_scan_plain on random opacities (some 0, some large), sources,
    evanescent flags and voxel validity against the JAX voxel scan, mode
    by mode."""
    rng = np.random.default_rng(nz * 100 + nf)
    f32 = np.float32
    tau = (10 ** rng.uniform(-6, 1, (2, nz, nf))).astype(f32)
    tau[:, ::4] = 0.0
    src = rng.uniform(0.0, 5.0, (2, nz, nf)).astype(f32)
    evan = rng.uniform(size=(2, nz, nf)) > 0.97
    m = rng.uniform(size=nz) > 0.1
    out = los_scans.dem_scan_plain(*map(torch.as_tensor, (tau, src, evan, m)))
    assert out.shape == (2, 2, nf)
    for mode in range(2):
        f, t_sum = _jax_dem_scan(tau[mode], src[mode], evan[mode], m)
        np.testing.assert_array_equal(np.isinf(out[mode, 1].numpy()),
                                      np.isinf(t_sum))
        np.testing.assert_allclose(out[mode, 0].numpy(), f, rtol=RTOL,
                                   atol=1e-30)
        np.testing.assert_allclose(out[mode, 1].numpy(), t_sum, rtol=RTOL)


def _dem_get_mw_args(mech, nz=24, nt=30, nf=6):
    """get_mw's DEM-mode arguments: a log-normal DEM per voxel, mechanism
    flags `mech` (3: free-free and gyroresonance, B of 40-300 G)."""
    rng = np.random.default_rng(17)
    t_grid = np.logspace(4.5, 6.8, nt)
    t_peak = 10 ** rng.uniform(5.2, 6.4, nz)
    em = 10 ** rng.uniform(24.0, 26.0, nz)
    prof = np.exp(-0.5 * (np.log(t_grid[:, None] / t_peak[None, :])
                          / 0.5) ** 2)
    w = np.gradient(t_grid)
    dem = em[None, :] * prof / np.sum(w[:, None] * prof, axis=0)
    ds = rng.uniform(5e8, 5e9, nz)
    parms = np.zeros((15, nz), order="F")
    parms[0] = ds
    parms[1] = np.sum(w[:, None] * dem * t_grid[:, None], axis=0) / em
    parms[2] = np.sqrt(em / ds)
    parms[3] = rng.uniform(0.5, 4.0, nz) * (75.0 if mech & 2 else 1.0)
    parms[4] = 70.0
    parms[6] = mech
    parms[7] = 30
    lparms = np.array([nz, nf, nt, 1, 0], np.int32)
    rparms = np.array([(0.045 * 6.957e10) ** 2, 150e6, 0.2])
    return lparms, rparms, parms, t_grid, dem


@pytest.mark.parametrize("mech", [1, 3])
def test_dem_get_mw_matches_jax(mech):
    """get_mw in DEM mode on the CPU (the plain recurrence) against the JAX
    get_mw, free-free and with gyroresonance: RL rows 1, 2, 5 and 6 within
    rtol 1e-5 (2e-4 with gyroresonance, the bar of tests/test_torch_
    get_mw.py for gyroresonance), and the launch counts unchanged."""
    lparms, rparms, parms, t_grid, dem = _dem_get_mw_args(mech)
    counts = dict(los_scans.LAUNCHES)
    rl = ptr.get_mw(lparms, rparms, parms, t=t_grid,
                    dem=np.asfortranarray(dem).ravel(order="F"),
                    device="cpu")
    assert los_scans.LAUNCHES == counts
    ref = jtr.get_mw(lparms, rparms, parms, t=t_grid, dem=dem)
    rtol = RTOL if mech == 1 else 2e-4
    for row in (1, 2, 5, 6):
        np.testing.assert_allclose(rl[row], ref[row], rtol=rtol, atol=1e-30,
                                   err_msg=f"RL[{row}]")
    assert np.all(rl[5] > 0)


def test_cpu_tensors_take_the_plain_path(model):
    """On CPU tensors the public entries (resample_var_to_cube,
    MASVariable.sample_sph, resample_cubes, sample_sph_many,
    sampler.valid_and_ds) return their plain versions' results and count
    no kernel launch."""
    counts = (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES))
    var = pmodel.MASModel(model)["rho"]
    grid = UniformGrid.cube(2.5, 11)
    cube = pmodel.resample_var_to_cube(var, grid, -140.0, fill_nan=None,
                                       device="cpu")
    axes = [torch.as_tensor(a, dtype=torch.float32) for a in grid.axes()]
    ref = resample.resample_cube_plain(*var.device_arrays("cpu"), *axes,
                                       -140.0, None)
    assert torch.equal(cube.isnan(), ref.isnan())
    assert torch.equal(cube.nan_to_num(), ref.nan_to_num())
    r = np.linspace(1.0, 5.0, 7, dtype=np.float32)
    got = var.sample_sph(r[:, None], np.float32(1.0),
                         np.linspace(0, 6, 5, dtype=np.float32),
                         device="cpu")
    want = resample.sample_sph_plain(
        *var.device_arrays("cpu"), torch.as_tensor(r[:, None]),
        torch.tensor(1.0), torch.linspace(0, 6, 5))
    assert got.shape == (7, 5) and torch.equal(got, want)
    arrays = pmodel.scene_arrays([var, pmodel.MASModel(model)["bt"]], "cpu")
    cubes = resample.resample_cubes(arrays, *axes, -140.0, None)
    assert torch.equal(cubes[0].nan_to_num(), ref.nan_to_num())
    many = resample.sample_sph_many(arrays, torch.as_tensor(r[:, None]),
                                    torch.tensor(1.0), torch.linspace(0, 6, 5))
    assert torch.equal(many[0], want)
    pos, s, start, usable = _records(2, n_rec=9, n_rays=9)
    args = [torch.as_tensor(a) for a in (pos, s, start)]
    for mask in (None, torch.as_tensor(usable)):
        a = psam.valid_and_ds(*args, usable=mask)
        b = los_scans.valid_ds_plain(*args, usable=mask)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES)) == counts


def test_wrappers_refuse_a_device_without_a_kernel(model):
    """A tensor on neither the CPU nor a CUDA card (here the meta device)
    goes to the kernel branch of each wrapper, which refuses it before
    anything is launched."""
    meta = torch.device("meta")
    var = pmodel.MASModel(model)["rho"]
    mesh = [t.to(meta) for t in var.device_arrays("cpu")]
    axes = [torch.empty(5, device=meta)] * 3
    counts = (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES))
    with pytest.raises(ValueError, match="no resampling kernel"):
        resample.resample_cube(*mesh, *axes)
    with pytest.raises(ValueError, match="no resampling kernel"):
        resample.sample_sph(*mesh, *axes)
    with pytest.raises(ValueError, match="no resampling kernel"):
        resample.resample_cubes([mesh, mesh], *axes)
    with pytest.raises(ValueError, match="no resampling kernel"):
        resample.sample_sph_many([mesh] * 5, *axes)
    with pytest.raises(ValueError, match="1 to 5 variables"):
        resample.resample_cubes([mesh] * 6, *axes)
    with pytest.raises(ValueError, match="1 to 5 variables"):
        resample.sample_sph_many([mesh] * 6, *axes)
    with pytest.raises(ValueError, match="no line-of-sight scan kernel"):
        los_scans.valid_ds(torch.empty(2, 3, 3, device=meta),
                           torch.empty(2, 3, device=meta),
                           torch.empty(3, 3, device=meta))
    with pytest.raises(ValueError, match="no line-of-sight scan kernel"):
        los_scans.dem_scan(torch.empty(2, 4, 3, device=meta),
                           torch.empty(2, 4, 3, device=meta),
                           torch.empty(2, 4, 3, dtype=torch.bool,
                                       device=meta),
                           torch.empty(4, dtype=torch.bool, device=meta))
    assert (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES)) == counts
