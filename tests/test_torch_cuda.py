"""Trace-segment kernel tests that need a CUDA card; each skips without
one. The file imports no jax, so it runs on a machine with PyTorch for
CUDA alone (the repository's conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.ops import trace_segment as ts
from raytracinggrff_tpu_torch.ops.trace_segment import (trace_segment,
                                                        trace_segment_plain)
from raytracinggrff_tpu_torch.tracer import init_k_vectors
from raytracinggrff_tpu_torch.tracer_segments import prepare_trace_inputs

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
# tolerances of tests/test_pallas_trace.py:52-65 per record row
ROW_TOL = [(2e-4, 2e-4)] * 3 + [(5e-4, 5e-3), (1e-2, 1e-3), (1.0, 1e-3),
                                (1e-3, 1e-3), (1e-4, 0.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["shipped", "fma"])
def exact(request, cuda, monkeypatch):
    """Whether the test runs the shipped build (NVCC_FLAGS, -fmad=false),
    which is exact, rather than the FMA build kept for measurement
    (FMA_NVCC_FLAGS). Without contraction the kernel rounds as the plain
    version's separate torch ops do, so its records rows 0-6 equal theirs
    (cos theta is computed in another order); the FMA build's are held to
    ROW_TOL."""
    if request.param == "fma":
        lib = ts.load_library(ts.build_library(ts.FMA_NVCC_FLAGS)[0])
        monkeypatch.setattr(ts, "_library", lambda: lib)
    return request.param == "shipped"


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


def _assert_records_match(rec_k, rec_p, exact):
    for row, (atol, rtol) in enumerate(ROW_TOL):
        if exact and row < 7:
            atol = rtol = 0.0
        torch.testing.assert_close(rec_k[:, row], rec_p[:, row], atol=atol,
                                   rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
@pytest.mark.parametrize("bvec", [False, True])
@pytest.mark.parametrize("crosssections", [True, False])
def test_kernel_matches_plain(cuda, exact, bvec, crosssections, s_mode):
    """Every record row against the plain version (rows 0-6 bit for bit in
    the exact build, per-step S included); the state carries cumulative S
    in both modes."""
    tcube, scube, state, grid = _inputs(cuda, bvec)
    args = (tcube, scube, state, grid, 5e-3, 1, 10, 8, 2.0, crosssections)
    launches = trace_segment.launches
    st_k, rec_k = trace_segment(*args, s_mode=s_mode)
    st_p, rec_p = trace_segment_plain(*args, s_mode=s_mode)
    torch.cuda.synchronize()
    assert trace_segment.launches == launches + 1
    _assert_records_match(rec_k, rec_p, exact)
    torch.testing.assert_close(st_k[:3], st_p[:3], atol=2e-4, rtol=2e-4)
    assert torch.all(rec_k[:, 3, :4] == (0.0 if crosssections else 1.0))
    if exact:
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
def test_cache_scenes_match_plain(cuda, exact, scene, bvec):
    args = _cache_scene(cuda, scene, bvec)
    st_k, rec_k = trace_segment(*args)
    st_p, rec_p = trace_segment_plain(*args)
    torch.cuda.synchronize()
    assert rec_k.shape == (args[-1], 8, 1000)
    _assert_records_match(rec_k, rec_p, exact)
    if exact:
        torch.testing.assert_close(st_k, st_p, atol=0, rtol=0,
                                   equal_nan=True)
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


def test_wrapper_refuses_mixed_devices(cuda):
    tcube, scube, state, grid = _inputs(cuda, False, n_rays=8, n=9)
    with pytest.raises(ValueError, match="is on"):
        trace_segment(tcube.cpu(), scube, state, grid, 5e-3, 1, 10, 1)
