"""Kernel tests that need a CUDA card (the trace segment and its input
cubes, the transfer folds, the MAS resample and spherical sampler, and the
line-of-sight scans); each skips without one. The file imports no jax, so it runs on a
machine with PyTorch for CUDA alone (the repository's conftest.py imports
jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu_torch.grff.transfer import transfer_carry_init
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.ops import _build
from raytracinggrff_tpu_torch.ops import trace_segment as ts
from raytracinggrff_tpu_torch.ops import transfer_fold as tf
from raytracinggrff_tpu_torch.ops.trace_segment import (
    pack_trace_inputs, pack_trace_inputs_plain, trace_segment,
    trace_segment_plain)
from raytracinggrff_tpu_torch.tracer import init_k_vectors
from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                      prepare_trace_inputs,
                                                      run_segments)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
# tolerance of tests/test_pallas_trace.py:52-65 for cos theta (row 7)
COS_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cubes(device, bvec, n):
    """The refracting scene of tests/test_pallas_trace.py at 80 MHz on an
    n^3 cube of extent 2, as trace and sample cubes."""
    grid = UniformGrid.cube(2.0, n)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    omega0 = 2 * np.pi * 80e6
    wpe = 0.9 * omega0 * np.exp(-(r - 1.0) / 0.6)
    wpe[r < 1.0] = 0.9 * omega0
    fields = [wpe, 1e8 * np.exp(-(r - 1.0) / 0.5), 1e6 + 1e5 * z,
              1.0 + 0.2 * x]
    if bvec:
        fields += [1.0 + 0.2 * x, 0.5 * y - 0.3, 0.2 - 0.4 * z]
    t = [torch.as_tensor(f.astype(np.float32), device=device)
         for f in fields]
    return (*prepare_trace_inputs(*t[:4], grid,
                                  tuple(t[4:]) if bvec else None), grid)


def _state(tcube, grid, start, kdir):
    start = torch.as_tensor(start, device=tcube.device)
    kdir = torch.as_tensor(kdir, device=tcube.device)
    k0 = init_k_vectors(tcube.reshape(-1, 4), grid, 80e6, start, kdir)
    ones = torch.ones(1, start.shape[0], device=tcube.device)
    return torch.cat([start.T, k0.T, ones]).contiguous()


def _bundle(n_rays, seed=0):
    """Ray starts near (0.6, 0, 1.9) heading -z."""
    rng = np.random.default_rng(seed)
    start = np.column_stack([0.6 + rng.uniform(-0.1, 0.1, n_rays),
                             rng.uniform(-0.1, 0.1, n_rays),
                             np.full(n_rays, 1.9)]).astype(np.float32)
    kdir = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n_rays, 1))
    return start, kdir


def _inputs(device, bvec, n_rays=512, n=33):
    """The bundle, with some rays outside the cube, in the scene of
    _cubes, and the initial state."""
    tcube, scube, grid = _cubes(device, bvec, n)
    start, kdir = _bundle(n_rays)
    start[:4, 0] = 50.0
    return tcube, scube, _state(tcube, grid, start, kdir), grid


def _assert_records_match(rec_k, rec_p):
    """Rows 0-6 bit for bit, NaN where the plain version has NaN: built
    with -fmad=false the kernel rounds as its separate torch ops do. Row 7,
    cos theta, is computed in another order."""
    torch.testing.assert_close(rec_k[:, :7], rec_p[:, :7], atol=0, rtol=0,
                               equal_nan=True)
    torch.testing.assert_close(rec_k[:, 7], rec_p[:, 7], atol=COS_ATOL,
                               rtol=0, equal_nan=True)


@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("crosssections", [True, False])
def test_kernel_matches_plain(cuda, bvec, crosssections, s_mode):
    """Every record row against the plain version (rows 0-6 bit for bit,
    per-step S included); the state carries cumulative S in both modes."""
    tcube, scube, state, grid = _inputs(cuda, bvec)
    args = (tcube, scube, state, grid, 5e-3, 1, 10, 8, 2.0, crosssections)
    launches = trace_segment.launches
    st_k, rec_k = trace_segment(*args, s_mode=s_mode)
    st_p, rec_p = trace_segment_plain(*args, s_mode=s_mode)
    torch.cuda.synchronize()
    assert trace_segment.launches == launches + 1
    _assert_records_match(rec_k, rec_p)
    torch.testing.assert_close(st_k[:3], st_p[:3], atol=2e-4, rtol=2e-4)
    assert torch.all(rec_k[:, 3, :4] == (0.0 if crosssections else 1.0))
    torch.testing.assert_close(st_k[6], st_p[6], atol=0, rtol=0,
                               equal_nan=True)
    if crosssections and s_mode == "per_step":
        st_c, rec_c = trace_segment(*args)
        torch.testing.assert_close(st_k, st_c, atol=0, rtol=0,
                                   equal_nan=True)
        assert not torch.equal(rec_k[1:, 3, 4:], rec_c[1:, 3, 4:])


def _cache_scene(device, scene, bvec, n_rays=1000):
    """Scenes that stress the kernel's per-ray cell cache, with a ragged
    ray count; returns (tcube, scube, state, grid, dt, n_first, stride,
    rps).
    large_dt: each RK4 stage moves a ray about two cells (dx = 1/16, a
        step 0.26), so nearly every evaluation misses;
    upper_faces: rays on the cube's faces x = 2, y = 2 and z = 2 and its
        corner, where locate clamps i0 = n-2 with weight 1;
    leaving: half the rays head +x from x = 1.8-1.95 and leave the cube
        mid-segment; 20 start at NaN."""
    n = 65 if scene == "large_dt" else 33
    tcube, scube, grid = _cubes(device, bvec, n)
    start, kdir = _bundle(n_rays, seed=1)
    dt, n_first, stride, rps = 5e-3, 1, 10, 16
    third = n_rays // 3
    if scene == "large_dt":
        dt, stride, rps = 0.6, 2, 4
    elif scene == "upper_faces":
        start[:third, 0] = 2.0
        start[third:2 * third, 1] = 2.0
        start[2 * third:, 2] = 2.0
        start[:8] = 2.0
    elif scene == "leaving":
        half = n_rays // 2
        start[:half, 0] = np.linspace(1.8, 1.95, half)
        kdir[:half] = (1.0, 0.0, 0.0)
        start[half:half + 20] = np.nan
    return (tcube, scube, _state(tcube, grid, start, kdir), grid, dt,
            n_first, stride, rps)


@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("scene", ["large_dt", "upper_faces", "leaving"])
def test_cache_scenes_match_plain(cuda, scene, bvec):
    args = _cache_scene(cuda, scene, bvec)
    st_k, rec_k = trace_segment(*args)
    st_p, rec_p = trace_segment_plain(*args)
    torch.cuda.synchronize()
    assert rec_k.shape == (args[-1], 8, 1000)
    _assert_records_match(rec_k, rec_p)
    torch.testing.assert_close(st_k, st_p, atol=0, rtol=0, equal_nan=True)
    if scene == "leaving":
        assert torch.isnan(rec_k[:, 0, 500:520]).all()
        frozen = rec_k[-1, 3, :500] == 0
        assert frozen.float().mean() > 0.5, frozen.float().mean()


def test_wide_index_matches_narrow(cuda, monkeypatch):
    """The kernel's 64-bit cube offsets give the records of its 32-bit
    ones."""
    tcube, scube, state, grid = _inputs(cuda, True)
    args = (tcube, scube, state, grid, 5e-3, 1, 10, 8)
    _, narrow = trace_segment(*args)
    monkeypatch.setattr(ts, "needs_wide_index", lambda *_: True)
    _, wide = trace_segment(*args)
    torch.testing.assert_close(wide, narrow, atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
def test_kernel_continues_across_segments(cuda, s_mode):
    """Two segments equal one segment with the same records; with per-step
    S the continued segment's first record is the last of its `stride`
    steps."""
    tcube, scube, state, grid = _inputs(cuda, True)
    kw = dict(s_mode=s_mode)
    _, whole = trace_segment(tcube, scube, state, grid, 5e-3, 1, 10, 6, **kw)
    mid, first = trace_segment(tcube, scube, state, grid, 5e-3, 1, 10, 2,
                               **kw)
    _, rest = trace_segment(tcube, scube, mid, grid, 5e-3, 10, 10, 4, **kw)
    torch.testing.assert_close(torch.cat([first, rest]), whole, rtol=0,
                               atol=0, equal_nan=True)


# The frozen-lane exit (csrc/trace_segment.cu): a lane whose step returns
# its input stops stepping. _freeze_scene's 160 rays, five warps: rays
# 0-63 head +x from x = 1.90-1.999 and leave the cube at staggered steps
# 1-48 (a lane freezes one step later: mid-block, on a block's last step
# and on the first launch's last step, FREEZE_LAUNCHES[0]); rays 64-95
# start outside, so their warp is frozen from the second launch on; rays
# 96-127 start outside but for ray LIVE_LANE, which stays in the cube;
# rays 128-159 mix NaN positions, -0.0 coordinates outside the cube, NaN
# and infinite k inside it, and live rays.
FREEZE_LAUNCHES = ((1, 5, 10), (5, 5, 4))    # (n_first, stride, rps)
LIVE_LANE = 111


def _freeze_scene(device, bvec):
    tcube, scube, grid = _cubes(device, bvec, 33)
    start, kdir = _bundle(160, seed=2)
    start[:64] = np.column_stack([np.linspace(1.90, 1.999, 64),
                                  np.full(64, 0.3), np.full(64, 0.5)])
    kdir[:64] = (1.0, 0.0, 0.0)
    outside = np.r_[64:128]
    start[outside[outside != LIVE_LANE], 0] = np.linspace(2.2, 50.0, 63)
    start[128:130] = np.nan
    start[130:132] = (-0.0, 0.3, 2.5)
    state = _state(tcube, grid, start, kdir)
    state[3, 132:136] = float("nan")
    state[4, 136:138] = float("inf")
    return tcube, scube, state, grid


def _freeze_steps(tcube, scube, state, grid, n_steps):
    """Per ray, the first of n_steps single plain steps that returns its
    state bit for bit with a ratio of +0 or NaN (0 if none does)."""
    first = torch.zeros(state.shape[1], dtype=torch.int64,
                        device=state.device)
    for j in range(1, n_steps + 1):
        nxt, rec = trace_segment_plain(tcube, scube, state, grid, 5e-3, 1, 1,
                                       1, s_mode="per_step")
        rho = rec[0, 3]
        same = ((nxt[:6].view(torch.int32) == state[:6].view(torch.int32))
                .all(dim=0) & ((rho.view(torch.int32) == 0) | rho.isnan()))
        first = torch.where((first == 0) & same, j, first)
        state = nxt
    return first.cpu()


def test_freeze_scene_covers_the_exit_cases(cuda):
    """The scene of test_kernel_exit_matches_plain freezes lanes mid-block,
    on a block's last step and on the first launch's last step; the warp
    of rays 64-95 is frozen when the second launch starts, and LIVE_LANE
    stays live through both launches among frozen lanes."""
    tcube, scube, state, grid = _freeze_scene(cuda, False)
    n_first, stride, rps = FREEZE_LAUNCHES[0]
    n_steps = n_first + (rps - 1) * stride
    first = _freeze_steps(tcube, scube, state, grid, n_steps)
    ends = {n_first + b * stride for b in range(rps)}
    leaving = first[:64].tolist()
    assert any(0 < j and j not in ends for j in leaving)
    assert any(j in ends and j < n_steps for j in leaving)
    assert n_steps in leaving
    assert (first[64:96] > 0).all() and (first[128:138] > 0).all()
    st = state
    for launch in FREEZE_LAUNCHES:
        st, _ = trace_segment_plain(tcube, scube, st, grid, 5e-3, *launch)
        if launch == FREEZE_LAUNCHES[0]:
            assert (~torch.isfinite(st[3:6, 64:96])).any(dim=0).all()
    assert torch.isfinite(st[3:6, LIVE_LANE]).all()
    assert (~torch.isfinite(st[3:6, 96:128])).any(dim=0).sum() == 31


@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("crosssections", [True, False])
def test_kernel_exit_matches_plain(cuda, crosssections, bvec, s_mode):
    """On _freeze_scene, two launches, the second continuing from the
    kernel's state: the records (rows 0-6) and the state of each equal the
    plain version's bit for bit (NaN where it has NaN)."""
    tcube, scube, state, grid = _freeze_scene(cuda, bvec)
    for launch in FREEZE_LAUNCHES:
        args = (tcube, scube, state, grid, 5e-3, *launch, 2.0,
                crosssections)
        st_k, rec_k = trace_segment(*args, s_mode=s_mode)
        st_p, rec_p = trace_segment_plain(*args, s_mode=s_mode)
        torch.cuda.synchronize()
        _assert_records_match(rec_k, rec_p)
        torch.testing.assert_close(st_k, st_p, atol=0, rtol=0,
                                   equal_nan=True)
        state = st_k


def test_wrapper_refuses_mixed_devices(cuda):
    tcube, scube, state, grid = _inputs(cuda, False, n_rays=8, n=9)
    with pytest.raises(ValueError, match="is on"):
        trace_segment(tcube.cpu(), scube, state, grid, 5e-3, 1, 10, 1)


# The trace-input kernel (rgrff_pack_trace_inputs) against its plain
# version on the card, bit for bit: the canonical 128^3 cube and the
# sweep's largest, 576^3; a non-cubic grid with distinct steps; an axis of
# two nodes on each axis; a ragged grid that fills no tile.
PACK_GRIDS = {
    "canonical": UniformGrid.cube(3.0, 128),
    "sweep_576": UniformGrid.cube(1.5, 576),
    "odd": UniformGrid(-1.0, 0.5, 2.0, 0.31, 0.17, 0.023, 7, 5, 3),
    "x_of_two": UniformGrid(0.0, 0.0, 0.0, 0.1, 0.2, 0.3, 2, 9, 33),
    "y_of_two": UniformGrid(0.0, 0.0, 0.0, 0.1, 0.2, 0.3, 9, 2, 33),
    "z_of_two": UniformGrid(0.0, 0.0, 0.0, 0.1, 0.2, 0.3, 9, 33, 2),
    "ragged": UniformGrid(-1.0, -1.0, -1.0, 0.013, 0.011, 0.017, 130, 129,
                          131)}


def _pack_fields(device, grid, dtype=torch.float32, special=False, seed=0):
    """omega_pe, ne, te, b, Bx, By, Bz on the device: the canonical density
    profile of harness.make_cube on the node radius plus 1% noise, or with
    `special` noise alone and NaN, +-inf, +-0 at a thousandth of the nodes
    and along every face."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = grid.shape
    axes = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in grid.axes()]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    r = torch.sqrt(x * x + y * y + z * z)
    ne = 4.2e4 * 10 ** (4.32 / torch.clamp(r, min=0.5))
    base = [8.93e3 * torch.sqrt(ne) * 2 * np.pi, ne, 1.4e6 + 0 * r,
            1.0 + 0.2 * x, 1.0 + 0.2 * x, 0.5 * y - 0.3, 0.2 - 0.4 * z]
    del x, y, z, r
    cubes = []
    for c in base:
        noise = torch.rand(shape, generator=gen, device=device, dtype=dtype)
        cubes.append(noise * c.abs().max() if special
                     else c * (0.995 + 0.01 * noise))
    if special:
        values = torch.tensor([np.nan, np.inf, -np.inf, 0.0, -0.0],
                              dtype=dtype, device=device)
        for c in cubes:
            pick = torch.randint(0, c.numel(), (max(c.numel() // 1000, 5),),
                                 generator=gen, device=device)
            c.view(-1)[pick] = values[torch.arange(pick.numel(),
                                                   device=device) % 5]
            for face in (c[0], c[-1], c[:, 0], c[:, -1], c[..., 0],
                         c[..., -1]):
                face[::3, ::2] = values[0]
                face[1::5, 1::3] = values[1]
    return cubes


def _assert_packs_equal(cubes, grid, bvec):
    """pack_trace_inputs launches once and equals pack_trace_inputs_plain
    on the same tensors bit for bit (int32 views)."""
    extra = tuple(cubes[4:]) if bvec else None
    launches = pack_trace_inputs.launches
    got = pack_trace_inputs(*cubes[:4], grid, extra)
    torch.cuda.synchronize()
    assert pack_trace_inputs.launches == launches + 1
    want = pack_trace_inputs_plain(*cubes[:4], grid, extra)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("grid_name", sorted(PACK_GRIDS))
def test_pack_kernel_matches_plain(cuda, grid_name, bvec):
    grid = PACK_GRIDS[grid_name]
    _assert_packs_equal(_pack_fields(cuda, grid), grid, bvec)


@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("grid_name", ["odd", "z_of_two", "ragged"])
def test_pack_kernel_matches_plain_on_non_finite_inputs(cuda, grid_name,
                                                        bvec):
    """NaN, +-inf and +-0 in every cube, on the faces too, come out as the
    plain version makes them, NaN bits included."""
    grid = PACK_GRIDS[grid_name]
    cubes = _pack_fields(cuda, grid, special=True)
    assert not torch.isfinite(cubes[0]).all()
    _assert_packs_equal(cubes, grid, bvec)


@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("grid_name", ["canonical", "ragged"])
def test_pack_kernel_converts_float64_as_plain(cuda, grid_name, bvec):
    """float64 cubes are rounded to float32 as the plain version's .to
    rounds them, before the gradient."""
    grid = PACK_GRIDS[grid_name]
    _assert_packs_equal(_pack_fields(cuda, grid, torch.float64), grid, bvec)


def test_prepare_trace_inputs_launches_the_pack_kernel_once(cuda):
    grid = PACK_GRIDS["odd"]
    cubes = _pack_fields(cuda, grid)
    for bvec in (None, tuple(cubes[4:])):
        launches = pack_trace_inputs.launches
        tcube, scube = prepare_trace_inputs(*cubes[:4], grid, bvec)
        assert pack_trace_inputs.launches == launches + 1
        assert tcube.device.type == "cuda" and scube.shape[3] == (
            4 if bvec is None else 8)


def test_pack_wrapper_refuses_mixed_devices(cuda):
    grid = PACK_GRIDS["odd"]
    cubes = _pack_fields(cuda, grid)
    with pytest.raises(ValueError, match="is on"):
        pack_trace_inputs(cubes[0], cubes[1].cpu(), *cubes[2:4], grid)


def test_canonical_trace_records_do_not_depend_on_the_pack(cuda):
    """The canonical trace (256^2 rays x 5000 steps x 128^3 at 75 MHz,
    eight segments) gives the same records, bit for bit, from the
    kernel's cubes as from the plain version's."""
    from raytracinggrff_tpu_torch.harness import make_cube, make_rays
    grid, wpe, ne = make_cube(128, 75e6)
    t = [torch.as_tensor(a, device=cuda) for a in (
        wpe, ne, np.full_like(ne, 1.4e6), np.ones_like(ne))]
    start, kdir = make_rays(256)
    traces = []
    for pack in (pack_trace_inputs, pack_trace_inputs_plain):
        tcube, scube = pack(*t, grid)
        state = initial_state(tcube, grid, 75e6, start, kdir)
        traces.append(torch.cat(list(run_segments(
            tcube, scube, state, grid, 6e-3, 5000, 10))))
    assert traces[0].shape == (500, 8, 65536)
    assert torch.equal(traces[0].view(torch.int32),
                       traces[1].view(torch.int32))


# The transfer folds against their plain versions on the card. Both run the
# same float32 ops in the same order (the kernel built with -fmad=false), so
# without gyroresonance the carries are equal (torch.equal); the
# gyroresonance harmonic sum alone may be added in another order by torch's
# reduction, so with it flux and finite tau are held to rtol 1e-4, and the
# infinite-tau (evanescent) and zero-flux sets must be equal. The kernels
# serve a ray with group_size(Nf) lanes and walk its records in chunks of
# that many, so the cases run every group size, partial groups (Nf 3, 5,
# 9), partial warps and blocks (1 and 37 rays), and invalid runs that
# straddle a chunk or fill it. At these ray counts the wrapper gives every
# ray 8 lanes (transfer_fold.group_size), so the *_at_every_group_size
# tests force each group size.
AREA = (0.045 * 6.957e10) ** 2
FOLD_NF = [1, 2, 3, 5, 8, 9]
FOLD_RAYS = [1, 37, 300]


def _fold_freqs(device, nf):
    return torch.tensor(75e6 * 10 ** (0.05 * np.arange(nf)),
                        dtype=torch.float32, device=device)


def _fold_records(device, n_rays=300, n_rec=32, seed=0, nf=3):
    """Records of rays walking from `start` with every kind of invalid
    record (NaN positions, S <= 0, cos theta NaN, ne NaN) and overdense
    voxels; B 0-15 G so that gyroresonance layers lie at 75-89 MHz. Rays 0-4
    leave at record 10 (if there are more than 6 rays); ray 5 (mod n_rays)
    has S = 0 at records 6-9, across the chunk boundary at 8, and ray 6 (mod
    n_rays) no position at records 16-23, a whole chunk of 8 (two of 4),
    before it is valid again."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(np.float32)
    pos = start[None] + np.cumsum(rng.normal(0.0, 0.01, (n_rec, n_rays, 3)),
                                  axis=0)
    rec = np.empty((n_rec, 8, n_rays))
    rec[:, 0:3] = pos.transpose(0, 2, 1)
    rec[:, 3] = rng.uniform(0.2, 2.0, (n_rec, n_rays))
    rec[:, 4] = 10 ** rng.uniform(5.0, 7.6, (n_rec, n_rays))
    rec[:, 5] = 10 ** rng.uniform(4.0, 6.5, (n_rec, n_rays))
    rec[:, 6] = rng.uniform(0.0, 15.0, (n_rec, n_rays))
    rec[:, 7] = rng.uniform(-1.0, 1.0, (n_rec, n_rays))
    u = rng.random((n_rec, n_rays))
    rec[:, 7][u < 0.05] = 0.0
    rec[:, 3][(u > 0.05) & (u < 0.1)] = 0.0
    rec[:, 7][(u > 0.1) & (u < 0.14)] = np.nan
    rec[:, 4][(u > 0.14) & (u < 0.16)] = np.nan
    rec[:, 4][(u > 0.16) & (u < 0.18)] = 3e8
    if n_rays > 6:
        rec[10:, 0:3, :5] = np.nan
    rec[6:10, 3, 5 % n_rays] = 0.0
    rec[16:24, 0:3, 6 % n_rays] = np.nan
    t = {k: torch.as_tensor(a, dtype=torch.float32, device=device)
         for k, a in (("recs", rec), ("start", start))}
    return t["recs"], t["start"], _fold_freqs(device, nf)


def _assert_folds_match(out, ref, mechanism):
    """Equal carries without gyroresonance; with it, rtol 1e-4 on flux and
    finite tau and equal infinite-tau and zero-flux sets."""
    for a, b in zip(out, ref):
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        assert torch.equal(a == 0, b == 0)
        if not mechanism & 2:
            assert torch.equal(a, b)
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], rtol=1e-4, atol=1e-30)


@pytest.mark.parametrize("n_rays", FOLD_RAYS)
@pytest.mark.parametrize("nf", FOLD_NF)
@pytest.mark.parametrize("gaunt", ["dulk", "exact"])
@pytest.mark.parametrize("theta_los", [False, True])
@pytest.mark.parametrize("mechanism", [1, 5, 7])
def test_fold_records_kernel_matches_plain(cuda, mechanism, theta_los,
                                           gaunt, nf, n_rays):
    recs, start, freqs = _fold_records(cuda, n_rays=n_rays, nf=nf)
    carry = transfer_carry_init(start.shape[0], nf, cuda)
    kw = dict(theta_deg=70.0, mechanism=mechanism, gaunt=gaunt, s_on=True,
              theta_los=theta_los)
    launches = tf.LAUNCHES["records"]
    out, prev = tf.fold_records(recs, carry, start, freqs, AREA, **kw)
    ref, prev_ref = tf.fold_records_plain(recs, carry, start, freqs, AREA,
                                          **kw)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["records"] == launches + 1
    _assert_folds_match(out, ref, mechanism)
    assert torch.equal(prev, prev_ref)
    if n_rays == 300:
        assert (torch.isinf(ref[2]).any()
                and (ref[0] > 0).float().mean() > 0.3)


@pytest.mark.parametrize("n_rays", FOLD_RAYS)
@pytest.mark.parametrize("nf", FOLD_NF)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("mechanism", [5, 7])
def test_fold_records_kernel_matches_plain_at_every_group_size(
        cuda, monkeypatch, mechanism, group, nf, n_rays):
    recs, start, freqs = _fold_records(cuda, n_rays=n_rays, nf=nf)
    carry = transfer_carry_init(start.shape[0], nf, cuda)
    kw = dict(theta_deg=70.0, mechanism=mechanism, s_on=True, theta_los=True)
    monkeypatch.setattr(tf, "group_size", lambda *_: group)
    out, prev = tf.fold_records(recs, carry, start, freqs, AREA, **kw)
    ref, prev_ref = tf.fold_records_plain(recs, carry, start, freqs, AREA,
                                          **kw)
    torch.cuda.synchronize()
    _assert_folds_match(out, ref, mechanism)
    assert torch.equal(prev, prev_ref)



@pytest.mark.parametrize("n_rays", FOLD_RAYS + [4096])
@pytest.mark.parametrize("n_rec", [1, 7, 32])
@pytest.mark.parametrize("theta_los", [False, True])
def test_fold_counts_kernel_matches_plain(cuda, theta_los, n_rec, n_rays):
    """The counting kernel's records stepped from and taken equal the
    plain count's, added to what the counters held, in one launch."""
    recs, start, _ = _fold_records(cuda, n_rays=n_rays)
    recs = recs[:n_rec].contiguous()
    counts = torch.tensor([3, 4], dtype=torch.int64, device=cuda)
    launches = tf.LAUNCHES["counts"]
    tf.fold_counts(recs, start, counts, theta_los)
    want = tf.fold_counts_plain(recs, start, theta_los)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["counts"] == launches + 1
    assert counts.tolist() == [3 + int(want[0]), 4 + int(want[1])]
    assert want[1] <= want[0] <= n_rec * n_rays
    assert want[1] > 0 or n_rec * n_rays < 32


def test_map_counts_folds_only_while_traced(cuda, tmp_path, monkeypatch):
    """A gyroresonance map with timings launches no count untraced;
    traced, one a segment, each equal to a count of the records its fold
    was given by the plain rule (los_scans.record_step, finite fields,
    ds > 0), and the map is the untraced one."""
    from raytracinggrff_tpu_torch.constants import R_SUN_CM
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.los_scans import record_step
    from raytracinggrff_tpu_torch.pipeline import (prepare_cubes,
                                                   run_ray_tracing_emission)
    model = MASModel(synthetic_mas_model(tmp_path / "m", nphi=16, ntheta=13,
                                         nr=24, b0_gauss=50.0))
    cubes = prepare_cubes(model, UniformGrid.cube(3.0, 48), 0.0,
                          verbose=False, keep_bvec=True, device=cuda)
    cfg = dict(n_pix=24, grid_n=48, dt=2e-2, n_steps=600, s_input_on=True,
               nfreq=11, freq_log_step=0.01, mechanism=7, theta_mode="los",
               seg_records=16)
    seen, fold = [], tf.fold_records

    def spy(recs, carry, prev, *a, **k):
        seen.append((recs.clone(), prev.clone()))
        return fold(recs, carry, prev, *a, **k)

    monkeypatch.setattr(tf, "fold_records", spy)
    timings = {}
    launches = tf.LAUNCHES["counts"]
    untraced = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                        device=cuda, timings=timings, **cfg)
    assert "fold_counts" not in timings and "count" not in timings
    assert tf.LAUNCHES["counts"] == launches
    seen.clear()
    traced_t = {}
    with torch.profiler.profile():
        traced = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                          device=cuda, timings=traced_t,
                                          **cfg)
    counts = traced_t["fold_counts"]
    assert len(counts) == len(seen) == traced_t["segments"]
    assert traced_t["count"] > 0.0
    assert tf.LAUNCHES["counts"] == launches + len(counts)
    for (recs, prev), got in zip(seen, counts):
        stepped = taken = 0
        for rec in recs:
            valid, ds, prev = record_step(rec[0:3].T, rec[3], prev,
                                          np.float32(R_SUN_CM),
                                          torch.isfinite(rec[7]))
            stepped += int(valid.sum())
            taken += int((valid & torch.isfinite(rec[4:7]).all(dim=0)
                          & torch.isfinite(ds) & (ds > 0)).sum())
        assert got == [stepped, taken]
    assert sum(t for _, t in counts) > 0
    for k in ("emission_cube", "emission_polVI_cube"):
        assert np.array_equal(traced[k], untraced[k])


def _fold_voxels(device, nz=20, n_pix=300, seed=1):
    """Voxels with invalid ones, NaN ne, ds = 0 and overdense ones, per-voxel
    theta (exact 90s among them), source areas and mechanism masks; pixel 5
    (mod n_pix) is invalid at voxels 6-9, across the chunk boundary at 8,
    and pixel 6 (mod n_pix) at 8-15, a whole chunk of 8."""
    rng = np.random.default_rng(seed)
    shape = (nz, n_pix)
    f32 = np.float32
    v = dict(ds=10 ** rng.uniform(8.0, 10.0, shape),
             te=10 ** rng.uniform(4.0, 6.5, shape),
             ne=10 ** rng.uniform(5.0, 7.6, shape),
             b=rng.uniform(0.0, 15.0, shape))
    u = rng.random(shape)
    v["ne"][(u > 0.1) & (u < 0.13)] = np.nan
    v["ne"][(u > 0.15) & (u < 0.18)] = 3e8
    v["ds"][(u > 0.13) & (u < 0.15)] = 0.0
    theta = rng.uniform(2.0, 178.0, shape)
    theta[(u > 0.18) & (u < 0.22)] = 90.0
    sarea = np.where(rng.random(shape) < 0.5,
                     rng.uniform(0.2, 3.0, shape) * AREA, 0.0)
    valid = u > 0.1
    valid[6:10, 5 % n_pix] = False
    valid[8:16, 6 % n_pix] = False
    out = [torch.as_tensor(v[k].astype(f32), device=device)
           for k in ("ds", "te", "ne", "b")]
    out.append(torch.as_tensor(valid, device=device))
    extra = dict(
        sarea=torch.as_tensor(sarea.astype(f32), device=device),
        theta=torch.deg2rad(torch.as_tensor(theta.astype(f32),
                                            device=device)),
        mech=torch.as_tensor(rng.choice(np.int32([0, 1, 4, 5, 7]), shape),
                             device=device))
    return out, extra


@pytest.mark.parametrize("n_pix", FOLD_RAYS)
@pytest.mark.parametrize("nf", FOLD_NF)
@pytest.mark.parametrize("per_voxel", [False, True])
@pytest.mark.parametrize("mechanism", [1, 5, 7])
def test_fold_voxels_kernel_matches_plain(cuda, mechanism, per_voxel, nf,
                                          n_pix):
    """A fixed theta without source areas, or per-voxel theta, source areas
    and mechanism masks."""
    vox, extra = _fold_voxels(cuda, n_pix=n_pix)
    freqs = _fold_freqs(cuda, nf) * 2.0
    kw = dict(mechanism=mechanism, gaunt="exact")
    if per_voxel:
        kw.update(extra, theta_deg=-1.0)
        kw["mech"] = kw["mech"] & mechanism
    else:
        kw.update(theta_deg=60.0)
    launches = tf.LAUNCHES["voxels"]
    out = tf.fold_voxels(*vox, freqs, AREA, **kw)
    ref = tf.fold_voxels_plain(*vox, freqs, AREA, **kw)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["voxels"] == launches + 1
    _assert_folds_match(out, ref, mechanism)


@pytest.mark.parametrize("n_pix", FOLD_RAYS)
@pytest.mark.parametrize("nf", FOLD_NF)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("mechanism", [5, 7])
def test_fold_voxels_kernel_matches_plain_at_every_group_size(
        cuda, monkeypatch, mechanism, group, nf, n_pix):
    vox, extra = _fold_voxels(cuda, n_pix=n_pix)
    freqs = _fold_freqs(cuda, nf) * 2.0
    kw = dict(extra, theta_deg=-1.0, mechanism=mechanism, gaunt="exact")
    kw["mech"] = kw["mech"] & mechanism
    monkeypatch.setattr(tf, "group_size", lambda *_: group)
    out = tf.fold_voxels(*vox, freqs, AREA, **kw)
    ref = tf.fold_voxels_plain(*vox, freqs, AREA, **kw)
    torch.cuda.synchronize()
    _assert_folds_match(out, ref, mechanism)


@pytest.mark.parametrize("nf", [3, 9])
@pytest.mark.parametrize("entry", ["records", "voxels"])
def test_fold_kernels_take_200_harmonics(cuda, entry, nf):
    """Mechanism 7 at s_max = 200, above the former cap of 128 harmonics,
    against the plain fold at the same cap; its tables staged in shared
    memory."""
    if entry == "records":
        recs, start, freqs = _fold_records(cuda, nf=nf)
        carry = transfer_carry_init(start.shape[0], nf, cuda)
        kw = dict(mechanism=7, s_max=200, s_on=True, theta_los=True)
        out, prev = tf.fold_records(recs, carry, start, freqs, AREA, **kw)
        ref, prev_ref = tf.fold_records_plain(recs, carry, start, freqs,
                                              AREA, **kw)
        assert torch.equal(prev, prev_ref)
    else:
        vox, extra = _fold_voxels(cuda)
        freqs = _fold_freqs(cuda, nf)
        kw = dict(extra, theta_deg=-1.0, mechanism=7, s_max=200)
        out = tf.fold_voxels(*vox, freqs, AREA, **kw)
        ref = tf.fold_voxels_plain(*vox, freqs, AREA, **kw)
    torch.cuda.synchronize()
    _assert_folds_match(out, ref, 7)


def test_fold_kernel_reads_large_tables_from_global_memory(cuda):
    """An s_max whose tables exceed a block's staged shared memory (48 KB):
    the kernel reads them from global memory and still matches the plain
    fold (few voxels: the plain fold's harmonic axis is s_max long). T is
    cut to 1e4-1e5 K, where every harmonic term stays finite up to s =
    7000."""
    vox, extra = _fold_voxels(cuda, nz=4, n_pix=37)
    vox[1] = torch.clamp(vox[1], max=1e5)
    freqs = _fold_freqs(cuda, 3)
    kw = dict(extra, theta_deg=-1.0, mechanism=7, s_max=7000)
    out = tf.fold_voxels(*vox, freqs, AREA, **kw)
    ref = tf.fold_voxels_plain(*vox, freqs, AREA, **kw)
    torch.cuda.synchronize()
    _assert_folds_match(out, ref, 7)


def test_get_mw_takes_any_harmonic_cap_on_the_card(cuda):
    """A uniform-T get_mw (mechanism 5) on the card with Parms[7] = 200
    runs, and equals the same call at Parms[7] = 30: without
    gyroresonance no harmonic is summed."""
    from raytracinggrff_tpu_torch.grff.transfer import get_mw
    nz = 40
    rng = np.random.default_rng(3)
    parms = np.zeros((15, nz))
    parms[0] = 1e8
    parms[1] = rng.uniform(1e6, 2e6, nz)
    parms[2] = rng.uniform(1e8, 2e8, nz)
    parms[3] = rng.uniform(1.0, 10.0, nz)
    parms[4] = 60.0
    parms[6] = 5
    lparms = [nz, 5, 0, 0, 0]
    rparms = [AREA, 300e6, 0.05]
    rl = {}
    for cap in (30, 200):
        parms[7] = cap
        launches = tf.LAUNCHES["voxels"]
        rl[cap] = get_mw(lparms, rparms, parms, device=cuda)
        assert tf.LAUNCHES["voxels"] == launches + 1
    assert np.isfinite(rl[200]).all() and (rl[200][5] > 0).all()
    np.testing.assert_array_equal(rl[200], rl[30])


@pytest.mark.parametrize("entry", ["records", "voxels"])
def test_fold_kernel_continues_across_calls(cuda, entry):
    """Two launches, the second from the first's carry, equal one launch
    over both halves bit for bit."""
    if entry == "records":
        recs, start, freqs = _fold_records(cuda)
        carry = transfer_carry_init(start.shape[0], 3, cuda)
        kw = dict(mechanism=7, s_on=True, theta_los=True)
        whole, prev_w = tf.fold_records(recs, carry, start, freqs, AREA, **kw)
        half, prev_h = tf.fold_records(recs[:9].contiguous(), carry, start,
                                       freqs, AREA, **kw)
        split, prev_s = tf.fold_records(recs[9:].contiguous(), half, prev_h,
                                        freqs, AREA, **kw)
        torch.testing.assert_close(prev_s, prev_w, rtol=0, atol=0)
    else:
        vox, extra = _fold_voxels(cuda)
        freqs = torch.tensor([150e6, 300e6], device=cuda)
        kw = dict(extra, theta_deg=-1.0, mechanism=7)
        whole = tf.fold_voxels(*vox, freqs, AREA, **kw)

        def part(sl):
            return ([a[sl].contiguous() for a in vox],
                    {k: a[sl].contiguous() for k, a in extra.items()})

        args, ex = part(slice(0, 7))
        half = tf.fold_voxels(*args, freqs, AREA, **dict(kw, **ex))
        args, ex = part(slice(7, None))
        split = tf.fold_voxels(*args, freqs, AREA, carry=half,
                               **dict(kw, **ex))
    for a, b in zip(split, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fold_wrappers_refuse_mixed_devices(cuda):
    recs, start, freqs = _fold_records(cuda, n_rays=8, n_rec=2)
    carry = transfer_carry_init(8, 3, cuda)
    with pytest.raises(ValueError, match="is on"):
        tf.fold_records(recs, carry, start.cpu(), freqs, AREA)
    vox, _ = _fold_voxels(cuda, nz=2, n_pix=8)
    with pytest.raises(ValueError, match="is on"):
        tf.fold_voxels(*vox[:4], vox[4].cpu(), freqs, AREA)


def test_fold_wrappers_launch_nothing_for_no_rays(cuda):
    """With no rays (an empty ray shard) each wrapper hands back the carry
    and positions it was given and counts no launch; rays without a
    frequency are refused."""
    recs, start, freqs = _fold_records(cuda, n_rays=8, n_rec=2)
    empty = transfer_carry_init(0, 3, cuda)
    counts = dict(tf.LAUNCHES)
    out, prev = tf.fold_records(recs[:, :, :0].contiguous(), empty,
                                start[:0], freqs, AREA)
    assert all(a is b for a, b in zip(out, empty)) and prev.shape == (0, 3)
    vox, _ = _fold_voxels(cuda, nz=2, n_pix=8)
    out = tf.fold_voxels(*(a[:, :0].contiguous() for a in vox), freqs, AREA)
    assert [tuple(a.shape) for a in out] == [(0, 3)] * 4
    assert tf.LAUNCHES == counts
    with pytest.raises(ValueError, match="at least one frequency"):
        tf.fold_records(recs, transfer_carry_init(8, 0, cuda), start,
                        freqs[:0], AREA)


# --- the scene kernels: csrc/resample_sph.cu and csrc/los_scans.cu --------

def _same(a, b):
    """Kernel result a equals plain result b: equal NaN masks, and every
    other entry equal (torch.equal)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.fixture(scope="module")
def mas_model(tmp_path_factory):
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    return MASModel(synthetic_mas_model(
        tmp_path_factory.mktemp("mas") / "m", nphi=16, ntheta=13, nr=24))


@pytest.mark.parametrize("n", [19, 64])
@pytest.mark.parametrize("fill", [None, 0.0])
@pytest.mark.parametrize("phi0", [0.0, -140.0])
@pytest.mark.parametrize("var", ["rho", "br"])
def test_resample_cube_kernel_matches_plain(cuda, mas_model, var, phi0, fill,
                                            n):
    """rgrff_resample_cube through resample_var_to_cube, one launch, equal
    to resample_cube_plain (NaN masks and values)."""
    from raytracinggrff_tpu_torch.mas.model import resample_var_to_cube
    from raytracinggrff_tpu_torch.ops import resample
    grid = UniformGrid.cube(2.5, n)
    before = resample.LAUNCHES["cube"]
    out = resample_var_to_cube(mas_model[var], grid, phi0, fill_nan=fill,
                               device="cuda")
    assert resample.LAUNCHES["cube"] == before + 1
    axes = [torch.as_tensor(a, dtype=torch.float32, device=cuda)
            for a in grid.axes()]
    ref = resample.resample_cube_plain(
        *mas_model[var].device_arrays(cuda), *axes, phi0, fill)
    assert out.shape == (n, n, n)
    assert _same(out, ref)
    assert torch.isnan(ref).any() == (fill is None)


@pytest.mark.parametrize("shape", [(1,), (37,), (300, 41)])
def test_sample_sph_kernel_matches_plain(cuda, mas_model, shape):
    """rgrff_sample_sph through MASVariable.sample_sph against
    sample_sph_plain at random queries with NaN, r off the mesh on both
    sides and phi outside [0, 2 pi)."""
    from raytracinggrff_tpu_torch.ops import resample
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    f32 = np.float32
    r = rng.uniform(0.9, 6.2, shape).astype(f32)
    colat = rng.uniform(-0.1, np.pi + 0.1, shape).astype(f32)
    phi = rng.uniform(-7.0, 13.0, shape).astype(f32)
    flat = r.reshape(-1)
    flat[:3] = [np.nan, 0.5, 7.0][:flat.size]
    var = mas_model["t"]
    before = resample.LAUNCHES["sph"]
    out = var.sample_sph(r, colat, phi, device="cuda")
    assert resample.LAUNCHES["sph"] == before + 1
    ref = resample.sample_sph_plain(
        *var.device_arrays(cuda),
        *(torch.as_tensor(a, device=cuda) for a in (r, colat, phi)))
    assert out.shape == shape and _same(out, ref)


def test_sample_sph_kernel_takes_broadcast_queries(cuda, mas_model):
    """MASVariable.sample_sph broadcasts its queries before the kernel,
    as the plain version does."""
    from raytracinggrff_tpu_torch.ops import resample
    var = mas_model["rho"]
    r = np.linspace(1.0, 5.0, 7, dtype=np.float32)[:, None]
    phi = np.linspace(-1.0, 7.0, 5, dtype=np.float32)
    out = var.sample_sph(r, np.float32(1.0), phi, device="cuda")
    ref = resample.sample_sph_plain(
        *var.device_arrays(cuda), torch.as_tensor(r, device=cuda),
        torch.tensor(1.0, device=cuda), torch.as_tensor(phi, device=cuda))
    assert out.shape == (7, 5) and _same(out, ref)


def _scene(cuda, kind, seed=3):
    """A scene of CUDA (data, phi, theta, r) tuples from a seed: 'one'
    variable; 'shared2' and 'shared5', variables on one mesh (its axes the
    same tensors); 'staggered2' (a mesh and its r half-steps) and
    'staggered5' (rho and t on one mesh, br, bt and bp on its r, theta and
    phi half-steps, as a MAS run staggers them); 'two_nodes', a mesh whose
    theta axis has 2 nodes beside one of 6."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    phi = np.sort(rng.uniform(0.0, 2 * np.pi, 12))
    theta = np.sort(rng.uniform(0.02, np.pi - 0.02, 10))
    r = 1.0 + 5.0 * np.sort(rng.uniform(0.0, 1.0, 14)) ** 1.5
    r[0] = 1.0

    def half(a):
        return 0.5 * (a[:-1] + a[1:])

    def axes(p, t, rr):
        return [torch.as_tensor(np.asarray(a, f32), device=cuda)
                for a in (np.concatenate([p, [p[0] + 2 * np.pi]]), t, rr)]

    base = axes(phi, theta, r)
    meshes = {
        "one": [base], "shared2": [base] * 2, "shared5": [base] * 5,
        "staggered2": [base, [*base[:2], axes(phi, theta, half(r))[2]]],
        "staggered5": [base, base, [*base[:2], axes(phi, theta, half(r))[2]],
                       [base[0], axes(phi, half(theta), r)[1], base[2]],
                       [axes(half(phi), theta, r)[0], *base[1:]]],
        "two_nodes": [[base[0], axes(phi, theta[[2, 7]], r)[1], base[2]],
                      [base[0], axes(phi, theta[:6], r)[1], base[2]]],
    }[kind]
    scene = []
    for m in meshes:
        data = rng.uniform(0.5, 2.0, tuple(a.shape[0] for a in m))
        data[-1] = data[0]
        data.flat[::97] = np.nan
        scene.append((torch.as_tensor(data.astype(f32), device=cuda), *m))
    return scene


def _cube_axes(cuda, shape, extent=2.5):
    """Cube axes of `shape`, each through 0 (an odd length) or about it."""
    out = []
    for n in shape:
        a = np.linspace(-extent, extent, n, dtype=np.float32)
        if n % 2:
            a[n // 2] = 0.0
        out.append(torch.as_tensor(a, device=cuda))
    return out


@pytest.mark.parametrize("shape,phi0,fill", [((130, 130, 130), 0.0, None),
                                             ((1, 7, 300), -140.0, 0.0),
                                             ((19, 41, 33), 24.0, None),
                                             ((19, 41, 33), -140.0, 0.0)])
@pytest.mark.parametrize("kind", ["one", "shared2", "shared5", "staggered2",
                                  "staggered5", "two_nodes"])
def test_resample_cubes_kernel_matches_plain(cuda, kind, shape, phi0, fill):
    """rgrff_resample_cube over a scene of 1, 2 or 5 variables on shared
    and staggered meshes, one launch, every variable's cube equal to
    resample_cube_plain's (NaN masks and values), on cubes whose sides are
    no multiple of the run length or of 128, with the voxel at the origin
    where all three sides are odd."""
    from raytracinggrff_tpu_torch.ops import resample
    scene = _scene(cuda, kind)
    axes = _cube_axes(cuda, shape)
    before = resample.LAUNCHES["cube"]
    outs = resample.resample_cubes(scene, *axes, phi0, fill)
    assert resample.LAUNCHES["cube"] == before + 1
    assert len(outs) == len(scene)
    for v, out in zip(scene, outs):
        ref = resample.resample_cube_plain(*v, *axes, phi0, fill)
        assert out.shape == shape and _same(out, ref)
    if fill is None and all(n % 2 for n in shape):
        mid = tuple(n // 2 for n in shape)
        assert all(torch.isnan(out[mid]) for out in outs)


def test_resample_cubes_kernel_matches_plain_at_576(cuda, mas_model):
    """The sweep's largest cube set, 576^3 at extent 1.5 and phi0 -140: the
    synthetic model's five variables in one launch, each equal to its
    plain cube."""
    from raytracinggrff_tpu_torch.mas.model import scene_arrays
    from raytracinggrff_tpu_torch.ops import resample
    names = ("rho", "t", "br", "bt", "bp")
    scene = scene_arrays([mas_model[v] for v in names], cuda)
    axes = [torch.as_tensor(a, dtype=torch.float32, device=cuda)
            for a in UniformGrid.cube(1.5, 576).axes()]
    outs = resample.resample_cubes(scene, *axes, -140.0, None)
    for v, out in zip(scene, outs):
        assert _same(out, resample.resample_cube_plain(*v, *axes, -140.0,
                                                       None))
        del out


@pytest.mark.parametrize("mesh", ["fine", "coarse"])
def test_resample_walk_matches_search(cuda, mesh):
    """The cube kernel walks a voxel's theta and r cells from the last
    voxel's and falls back to the binary search after a few nodes: on
    axes far finer than the cube (2,000 theta and 4,000 r nodes, hundreds
    between voxels) and far coarser (3 nodes each), on a cube whose sides
    the run length does not divide, its cubes equal the plain version's,
    whose torch.searchsorted is the binary search."""
    from raytracinggrff_tpu_torch.ops import resample
    rng = np.random.default_rng(11)
    nt, nr = (2000, 4000) if mesh == "fine" else (3, 3)
    theta = np.linspace(0.01, np.pi - 0.01, nt, dtype=np.float32)
    r = (1.0 + 5.0 * np.linspace(0.0, 1.0, nr) ** 1.5).astype(np.float32)
    phi = np.linspace(0.0, 2 * np.pi, 13, dtype=np.float32)
    data = rng.uniform(0.5, 2.0, (13, nt, nr)).astype(np.float32)
    data[-1] = data[0]
    var = [torch.as_tensor(a, device=cuda) for a in (data, phi, theta, r)]
    axes = _cube_axes(cuda, (37, 45, 37), extent=6.5)
    ref = resample.resample_cube_plain(*var, *axes, -140.0, None)
    assert _same(resample.resample_cube(*var, *axes, -140.0, None), ref)


@pytest.mark.parametrize("shape", [(1,), (37,), (300, 41)])
@pytest.mark.parametrize("kind", ["one", "shared2", "shared5", "staggered2",
                                  "staggered5", "two_nodes"])
def test_sample_sph_many_kernel_matches_plain(cuda, kind, shape):
    """rgrff_sample_sph over a scene of 1, 2 or 5 variables on shared and
    staggered meshes, one launch, at random queries with NaN, r off the
    mesh on both sides and phi outside [0, 2 pi): every variable's samples
    equal sample_sph_plain's."""
    from raytracinggrff_tpu_torch.ops import resample
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    f32 = np.float32
    q = [rng.uniform(0.9, 6.2, shape).astype(f32),
         rng.uniform(-0.1, np.pi + 0.1, shape).astype(f32),
         rng.uniform(-7.0, 13.0, shape).astype(f32)]
    for a, bad in zip(q, ([np.nan, 0.5, 7.0], [1.0, np.nan, 1.0],
                          [1.0, 1.0, np.nan])):
        a.reshape(-1)[:3] = bad[:a.size]
    q = [torch.as_tensor(a, device=cuda) for a in q]
    scene = _scene(cuda, kind)
    before = resample.LAUNCHES["sph"]
    outs = resample.sample_sph_many(scene, *q)
    assert resample.LAUNCHES["sph"] == before + 1
    for v, out in zip(scene, outs):
        ref = resample.sample_sph_plain(*v, *q)
        assert out.shape == shape and _same(out, ref)


def test_scene_paths_launch_once(cuda, mas_model):
    """prepare_cubes launches the cube resample once for its five
    variables, resample_mas_los the sampler once; their results equal the
    plain versions' (chip_smoke.plain_scenes' routing)."""
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.pipeline import (prepare_cubes,
                                                   resample_mas_los)
    grid = UniformGrid.cube(3.0, 33)
    before = dict(resample.LAUNCHES)
    cubes = prepare_cubes(mas_model, grid, 10.0, verbose=False,
                          keep_bvec=True, device="cuda")
    assert resample.LAUNCHES == dict(before, cube=before["cube"] + 1)
    kw = dict(n_pix=12, n_z=30, dz0=3e-3, verbose=False, device="cuda")
    los = resample_mas_los(mas_model.path, **kw)
    assert resample.LAUNCHES == dict(before, cube=before["cube"] + 1,
                                     sph=before["sph"] + 1)
    saved = resample.resample_cubes, resample.sample_sph_many
    try:
        resample.resample_cubes = resample.resample_cubes_plain
        resample.sample_sph_many = resample.sample_sph_many_plain
        cubes_p = prepare_cubes(mas_model, grid, 10.0, verbose=False,
                                keep_bvec=True, device="cuda")
        los_p = resample_mas_los(mas_model.path, **kw)
    finally:
        resample.resample_cubes, resample.sample_sph_many = saved
    for key in ("omega_pe", "ne", "te", "b"):
        assert _same(cubes[key], cubes_p[key]), key
    assert all(_same(a, b) for a, b in zip(cubes["bvec"], cubes_p["bvec"]))
    for key in ("Ne_LOS", "Te_LOS", "B_LOS"):
        assert np.array_equal(los[key], los_p[key], equal_nan=True), key


def test_scene_kernel_failures_raise(cuda, monkeypatch, tmp_path):
    """A launch the C entry refuses raises and counts nothing, and so does
    a kernel library that fails to build: nothing falls back to the plain
    version."""
    from raytracinggrff_tpu_torch.ops import resample
    scene = _scene(cuda, "shared2")
    axes = _cube_axes(cuda, (9, 9, 9))
    before = dict(resample.LAUNCHES)
    # axes beyond the card's shared memory, let past the wrapper's check:
    # the C entry refuses them
    monkeypatch.setattr(resample, "MAX_SHARED_BYTES", 1 << 30)
    big = torch.linspace(1.0, 9.0, 60_000, device=cuda)
    wide = (torch.zeros(*scene[0][0].shape[:2], 60_000, device=cuda),
            *scene[0][1:3], big)
    with pytest.raises(RuntimeError, match="rgrff_resample_cube launch "
                                           "failed"):
        resample.resample_cubes([scene[0], wide], *axes)
    with pytest.raises(RuntimeError, match="rgrff_sample_sph launch failed"):
        resample.sample_sph_many([wide], *axes)
    assert resample.LAUNCHES == before
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library",
                        lambda: _build.load_library(
                            _build.build_library()[0]))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        resample.sample_sph_many(scene, *axes)
    assert resample.LAUNCHES == before


def _scan_records(device, n_rec, n_rays, seed=0):
    """Straight records (n_rec, n_rays, 3) with NaN and inf positions, NaN
    and non-positive cross-sections, ray starts and a `usable` mask."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    start = rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(f32)
    dirs = rng.normal(size=(n_rays, 3)).astype(f32)
    t = (np.arange(1, n_rec + 1, dtype=f32) * 0.02)[:, None, None]
    pos = (start[None] + t * dirs[None]).astype(f32)
    pos[::6, ::5, 1] = np.nan
    pos[::11, ::7] = np.inf
    s = rng.uniform(0.5, 2.0, (n_rec, n_rays)).astype(f32)
    s[::5, ::3] = 0.0
    s[::7, ::4] = -1.0
    s[::9, ::2] = np.nan
    usable = rng.uniform(size=(n_rec, n_rays)) > 0.2
    return [torch.as_tensor(a, device=device)
            for a in (pos, s, start, usable)]


@pytest.mark.parametrize("with_usable", [False, True])
@pytest.mark.parametrize("n_rays", [1, 37, 300])
@pytest.mark.parametrize("n_rec", [1, 7, 50])
def test_valid_ds_kernel_matches_plain(cuda, n_rec, n_rays, with_usable):
    from raytracinggrff_tpu_torch.ops import los_scans
    pos, s, start, usable = _scan_records(cuda, n_rec, n_rays, n_rec + n_rays)
    mask = usable if with_usable else None
    before = los_scans.LAUNCHES["valid_ds"]
    got = los_scans.valid_ds(pos, s, start, usable=mask)
    assert los_scans.LAUNCHES["valid_ds"] == before + 1
    want = los_scans.valid_ds_plain(pos, s, start, usable=mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_valid_and_ds_takes_strided_records(cuda):
    """sampler.valid_and_ds hands the kernel contiguous copies of strided
    views, as _center_los passes them."""
    from raytracinggrff_tpu_torch.ops import los_scans
    from raytracinggrff_tpu_torch.sampler import valid_and_ds
    pos, s, start, usable = _scan_records(cuda, 20, 16)
    rows = torch.cat([pos, s[:, :, None]], dim=2).transpose(1, 2)
    got = valid_and_ds(rows[:, 0:3].transpose(1, 2), rows[:, 3], start,
                       usable=usable.T.contiguous().T)
    want = los_scans.valid_ds_plain(pos, s, start, usable=usable)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("nf", [1, 3, 100])
@pytest.mark.parametrize("nz", [0, 1, 50])
def test_dem_scan_kernel_matches_plain(cuda, nz, nf):
    from raytracinggrff_tpu_torch.ops import los_scans
    rng = np.random.default_rng(nz * 1000 + nf)
    f32 = np.float32
    tau = (10 ** rng.uniform(-6, 1, (2, nz, nf))).astype(f32)
    tau[:, ::4] = 0.0
    src = rng.uniform(0.0, 5.0, (2, nz, nf)).astype(f32)
    evan = rng.uniform(size=(2, nz, nf)) > 0.97
    m = rng.uniform(size=nz) > 0.1
    args = [torch.as_tensor(a, device=cuda) for a in (tau, src, evan, m)]
    before = los_scans.LAUNCHES["dem"]
    got = los_scans.dem_scan(*args)
    assert los_scans.LAUNCHES["dem"] == before + 1
    assert torch.equal(got, los_scans.dem_scan_plain(*args))


@pytest.mark.parametrize("mech", [1, 3, 5])
def test_get_mw_dem_mode_kernel_matches_plain(cuda, monkeypatch, mech):
    """get_mw in DEM mode on the card launches the DEM scan once, and its
    RL equals the RL with the plain recurrence; free-free, with
    gyroresonance (B of 40-300 G) and with neutrals."""
    from raytracinggrff_tpu_torch.grff import transfer
    from raytracinggrff_tpu_torch.ops import los_scans
    rng = np.random.default_rng(mech)
    nz, nt, nf = 40, 30, 12
    t_grid = np.logspace(4.5, 6.8, nt)
    t_peak = 10 ** rng.uniform(5.2, 6.4, nz)
    em = 10 ** rng.uniform(24.0, 26.0, nz)
    prof = np.exp(-0.5 * (np.log(t_grid[:, None] / t_peak[None, :])
                          / 0.5) ** 2)
    w = np.gradient(t_grid)
    dem = em[None, :] * prof / np.sum(w[:, None] * prof, axis=0)
    parms = np.zeros((15, nz), order="F")
    parms[0] = rng.uniform(5e8, 5e9, nz)
    parms[1] = np.sum(w[:, None] * dem * t_grid[:, None], axis=0) / em
    parms[2] = np.sqrt(em / parms[0])
    parms[3] = rng.uniform(0.5, 4.0, nz) * (75.0 if mech & 2 else 1.0)
    parms[4], parms[6], parms[7] = 70.0, mech, 30
    args = (np.array([nz, nf, nt, 1, 0], np.int32),
            np.array([AREA, 150e6, 0.05]), parms, t_grid,
            np.asfortranarray(dem).ravel(order="F"))
    before = los_scans.LAUNCHES["dem"]
    rl = transfer.get_mw(*args, device="cuda")
    assert los_scans.LAUNCHES["dem"] == before + 1
    monkeypatch.setattr(transfer, "dem_scan", los_scans.dem_scan_plain)
    assert np.array_equal(rl, transfer.get_mw(*args, device="cuda"))
    assert np.all(np.isfinite(rl[5])) and np.all(rl[5] > 0)


def test_scene_wrappers_refuse_what_the_kernels_do_not_take(cuda,
                                                            mas_model):
    """Wrong dtype, a non-contiguous tensor, a tensor on the CPU beside
    CUDA ones, mismatched shapes, a scene of no or more than 5 variables
    and axes beyond the shared memory are refused before any launch."""
    from raytracinggrff_tpu_torch.ops import los_scans, resample
    mesh = list(mas_model["rho"].device_arrays(cuda))
    axes = [torch.linspace(-2, 2, 9, device=cuda)] * 3
    counts = (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES))
    with pytest.raises(TypeError, match="float32"):
        resample.resample_cube(mesh[0].double(), *mesh[1:], *axes)
    with pytest.raises(ValueError, match="contiguous"):
        resample.resample_cube(mesh[0].transpose(1, 2).contiguous()
                               .transpose(1, 2), *mesh[1:], *axes)
    with pytest.raises(ValueError, match="is on"):
        resample.resample_cube(*mesh, axes[0].cpu(), *axes[1:])
    with pytest.raises(ValueError, match="must be"):
        resample.resample_cube(mesh[0][:-1].contiguous(), *mesh[1:], *axes)
    q = torch.ones(4, 5, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        resample.sample_sph(*mesh, q.T, q.T.contiguous(), q.T.contiguous())
    with pytest.raises(ValueError, match="one shape"):
        resample.sample_sph(*mesh, q, q, q[:, :2].contiguous())
    with pytest.raises(TypeError, match="float32"):
        resample.sample_sph(*mesh, q.double(), q, q)
    with pytest.raises(ValueError, match="1 to 5 variables"):
        resample.resample_cubes([mesh] * 6, *axes)
    with pytest.raises(ValueError, match="1 to 5 variables"):
        resample.sample_sph_many([], q, q, q)
    with pytest.raises(ValueError, match="is on"):
        resample.resample_cubes([mesh, [m.cpu() for m in mesh]], *axes)
    with pytest.raises(ValueError, match="contiguous"):
        resample.sample_sph_many(
            [mesh, [mesh[0].transpose(1, 2).contiguous().transpose(1, 2),
                    *mesh[1:]]], q, q, q)
    with pytest.raises(ValueError, match="must be"):
        resample.resample_cubes([mesh, [mesh[0], *mesh[1:3], mesh[3][:-1]]],
                                *axes)
    with pytest.raises(ValueError, match="one shape"):
        resample.sample_sph_many([mesh] * 2, q, q, q[:, :2].contiguous())
    big = torch.linspace(1.0, 9.0, 60_000, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        resample.sample_sph_many(
            [mesh, (torch.zeros(mesh[0].shape[0], mesh[0].shape[1], 60_000,
                                device=cuda), *mesh[1:3], big)], q, q, q)
    pos, s, start, usable = _scan_records(cuda, 5, 8)
    with pytest.raises(TypeError, match="float32"):
        los_scans.valid_ds(pos.double(), s, start)
    with pytest.raises(TypeError, match="bool"):
        los_scans.valid_ds(pos, s, start, usable=usable.float())
    with pytest.raises(ValueError, match="contiguous"):
        los_scans.valid_ds(pos.transpose(0, 1).contiguous().transpose(0, 1),
                           s, start)
    with pytest.raises(ValueError, match="is on"):
        los_scans.valid_ds(pos, s, start.cpu())
    with pytest.raises(ValueError, match="must be"):
        los_scans.valid_ds(pos, s[:, :4].contiguous(), start)
    tau = torch.zeros(2, 6, 3, device=cuda)
    evan = torch.zeros(2, 6, 3, dtype=torch.bool, device=cuda)
    m = torch.ones(6, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="bool"):
        los_scans.dem_scan(tau, tau, evan.float(), m)
    with pytest.raises(ValueError, match="is on"):
        los_scans.dem_scan(tau, tau, evan, m.cpu())
    with pytest.raises(ValueError, match="must be"):
        los_scans.dem_scan(tau, tau, evan, m[:5])
    with pytest.raises(ValueError, match="contiguous"):
        los_scans.dem_scan(tau.transpose(1, 2).contiguous().transpose(1, 2),
                           tau, evan, m)
    assert (dict(resample.LAUNCHES), dict(los_scans.LAUNCHES)) == counts


def test_highband_800mhz_maps_match_the_references(cuda, tmp_path):
    """compare_los_raytracing's 800 MHz preset at 128^2 (the 520^3 cube,
    12,000 steps at stride 5, the LOS map of 1,100 voxels) on the card:
    both maps finite, and at 256 sampled pixels each equal to its plain
    reference (benchmark/reference/map.py, benchmark/reference/los.py)
    within the compare_800mhz cell's limits."""
    import dataclasses
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark.gen.mas import mas_arrays, write_mas_dir
    from benchmark.reference.los import los_pixels
    from benchmark.reference.map import map_pixels
    from benchmark.yardstick.compare import map_gaps
    from raytracinggrff_tpu_torch.cli.compare_los_raytracing import (
        HIGHBAND_PRESETS, compare_frequency)
    from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig
    config = json.loads((root / "benchmark/configs/highband_800mhz.json")
                        .read_text())
    limits = json.loads((root / "benchmark/traffic/compare_closed.json")
                        .read_text())["check"]["limits"]
    arrays, mesh = mas_arrays(config["scene"], 2 ** 31 + 5)
    path = write_mas_dir(tmp_path / "corona", arrays, mesh,
                         config["scene"]["timestep"])
    preset = HIGHBAND_PRESETS[800e6]
    ray, los = compare_frequency(str(path), 800e6, n_pix=128, x_fov=1.44,
                                 phi0_offset=0.0, highband=True,
                                 verbose=False, device="cuda")
    for res in (ray, los):
        for key in ("emission_cube", "emission_polVI_cube"):
            assert res[key].shape == (128, 128, 1)
            assert np.isfinite(res[key]).all(), key
    pixels = np.sort(np.random.default_rng(11).choice(128 * 128, 256,
                                                      replace=False))
    run = dict(dataclasses.asdict(RayEmissionConfig()), n_pix=128,
               x_fov=1.44, freq_hz=800e6, phi0_offset=0.0,
               **{k: v for k, v in preset.items()
                  if k not in ("dz0", "n_z")})
    torch.cuda.empty_cache()
    want = map_pixels(arrays, mesh, run, pixels, cuda)
    got = [ray[k].reshape(-1, 1)[pixels]
           for k in ("emission_cube", "emission_polVI_cube")]
    gaps = map_gaps(got[0], want[0], got[1], want[1])
    assert gaps["tb_gap"] <= limits["tb_gap"], gaps
    assert gaps["vi_gap"] <= limits["vi_gap"], gaps
    los_cfg = dict(config["los"], n_z=preset["n_z"], dz0=preset["dz0"])
    want = los_pixels(arrays, mesh, run, los_cfg, pixels, cuda)
    got = [los[k].reshape(-1, 1)[pixels]
           for k in ("emission_cube", "emission_polVI_cube")]
    gaps = map_gaps(got[0], want[0], got[1], want[1])
    assert gaps["tb_gap"] <= limits["los_tb_gap"], gaps
    assert gaps["vi_gap"] <= limits["los_vi_gap"], gaps
    assert min(ray["emission_cube"].max(), los["emission_cube"].max()) > 1e5
