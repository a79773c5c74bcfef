"""The trace-segment kernel's plain version, through the segment driver,
against the JAX XLA tracer plus its sampler on the scenes of
tests/test_pallas_trace.py, and the tracer building blocks against their
JAX twins. Tolerances are those of tests/test_pallas_trace.py:52-65."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu import tracer as jtracer
from raytracinggrff_tpu.constants import C_R
from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu.sampler import (cos_theta_signed,
                                        pack_model_table,
                                        sample_model_with_rays)
from raytracinggrff_tpu_torch import tracer
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.ops.trace_segment import (pack_trace_inputs,
                                                        trace_segment,
                                                        trace_segment_plain)
from raytracinggrff_tpu_torch.tracer_segments import (prepare_trace_inputs,
                                                      segment_plan,
                                                      trace_rays_segments)

torch.set_num_threads(1)
FREQ = 80e6


def _scene(n=41, extent=2.0, freq=FREQ):
    grid = JaxGrid.cube(extent, n)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    omega0 = 2 * np.pi * freq
    wpe = (0.9 * omega0 * np.exp(-(r - 1.0) / 0.6)).astype(np.float32)
    wpe[r < 1.0] = 0.9 * omega0
    ne = (1e8 * np.exp(-(r - 1.0) / 0.5)).astype(np.float32)
    te = (1e6 + 1e5 * z).astype(np.float32)
    b = (1.0 + 0.2 * x).astype(np.float32)
    bvec = tuple(c.astype(np.float32) for c in
                 (1.0 + 0.2 * x, 0.5 * y - 0.3, 0.2 - 0.4 * z))
    return grid, wpe, ne, te, b, bvec


def _bundle(n_rays, cx=0.6, cy=0.0, spread=0.1, z=1.9, seed=0):
    rng = np.random.default_rng(seed)
    start = np.column_stack([
        cx + rng.uniform(-spread, spread, n_rays),
        cy + rng.uniform(-spread, spread, n_rays),
        np.full(n_rays, z)]).astype(np.float32)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_rays, 1))
    return start, kdir


def _port_grid(grid):
    return UniformGrid(grid.x0, grid.y0, grid.z0, grid.dx, grid.dy, grid.dz,
                       grid.nx, grid.ny, grid.nz)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _compare(grid, wpe, ne, te, b, start, kdir, dt, n_steps, stride,
             seg_records=4, bvec=None, s_mode="cumulative",
             crosssections=True):
    """Port records vs JAX trace_rays + sample_model_with_rays."""
    res_p = trace_rays_segments(
        *_t(wpe, ne, te, b), _port_grid(grid), FREQ, start, kdir, dt,
        n_steps, stride, trace_crosssections=crosssections,
        seg_records=seg_records, bvec=None if bvec is None else _t(*bvec),
        s_mode=s_mode)
    table = jtracer.pack_trace_table(jnp.asarray(wpe), grid)
    res_x = jtracer.trace_rays(table, grid, FREQ, jnp.asarray(start),
                               jnp.asarray(kdir), dt, n_steps, stride,
                               trace_crosssections=crosssections,
                               s_mode=s_mode, record_k=True)
    np.testing.assert_allclose(res_p.r_record, np.asarray(res_x.r_record),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res_p.s_record, np.asarray(res_x.s_record),
                               rtol=5e-3, atol=5e-4)
    mt = pack_model_table(ne, te, b, bvec=bvec)
    sampled = sample_model_with_rays(mt, grid, res_x.r_record,
                                     res_x.s_record, jnp.asarray(start))
    np.testing.assert_allclose(res_p.ne, np.asarray(sampled.ne),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(res_p.te, np.asarray(sampled.te),
                               rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(res_p.b, np.asarray(sampled.b),
                               rtol=1e-3, atol=1e-3)
    return res_p, res_x, sampled


def test_refracting_bundle_matches_xla():
    grid, wpe, ne, te, b, _ = _scene()
    start, kdir = _bundle(128)
    _compare(grid, wpe, ne, te, b, start, kdir, dt=5e-3, n_steps=71,
             stride=10)


def test_out_of_cube_rays_frozen():
    grid, wpe, ne, te, b, _ = _scene()
    start, kdir = _bundle(128, cx=0.3)
    start[:5, 0] = 50.0   # far outside the cube
    res, _, _ = _compare(grid, wpe, ne, te, b, start, kdir, dt=5e-3,
                         n_steps=71, stride=10)
    # frozen rays never move, their S collapses to 0, fields take fills
    np.testing.assert_allclose(res.r_record[:, :5, 0], 50.0)
    assert np.all(res.s_record[-1, :5] < 1e-6)
    np.testing.assert_array_equal(res.te[:, :5], 1e4)
    np.testing.assert_array_equal(res.ne[:, :5], 0.0)


def test_record_schedule_matches_reference():
    """Records land after steps 1, 1+stride, ... (build_rays.py:241)."""
    grid, wpe, ne, te, b, _ = _scene()
    start = np.tile(np.float32([[1.9, 1.9, 1.9]]), (16, 1))
    kdir = np.tile(np.float32([[-1.0, 0.0, 0.0]]), (16, 1))
    res = trace_rays_segments(*_t(np.zeros_like(wpe), ne, te, b),
                              _port_grid(grid), FREQ, start, kdir, 1e-2, 25,
                              10)
    assert res.r_record.shape == (3, 16, 3)
    for j, steps in enumerate([1, 11, 21]):
        np.testing.assert_allclose(res.r_record[j, 0, 0],
                                   1.9 - C_R * 1e-2 * steps, rtol=1e-5)


def test_cos_theta_matches_signed_cos_with_record_k():
    grid, wpe, ne, te, b, bvec = _scene()
    start, kdir = _bundle(128, cx=0.4, seed=3)
    start[:3, 1] = -40.0   # frozen rays: NaN k gives NaN cos in both
    res, res_x, _ = _compare(grid, wpe, ne, te, b, start, kdir,
                             dt=5e-3, n_steps=71, stride=10, bvec=bvec)
    bv = _b_at_records(bvec, grid, res_x.r_record)
    ref = np.asarray(cos_theta_signed(res_x.k_record, bv))
    np.testing.assert_array_equal(np.isnan(res.cos_theta), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(res.cos_theta[ok], ref[ok], atol=1e-4)
    assert np.abs(res.cos_theta[ok]).max() > 0.1   # a real signal


def _b_at_records(bvec, grid, r):
    """The B vector at the JAX records, 0 outside the cube."""
    from raytracinggrff_tpu.ops.trilinear import pack_fields, trilinear_packed
    v, _ = trilinear_packed(pack_fields(*bvec), grid, r[..., 0], r[..., 1],
                            r[..., 2])
    return jnp.where(jnp.isfinite(v), v, 0.0)


@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
def test_segments_equal_one_segment(s_mode):
    """seg_records=7 yields exactly the records of a single segment: a
    continued segment's first record runs `stride` steps, and its per-step
    S is the last of those."""
    grid, wpe, ne, te, b, bvec = _scene()
    start, kdir = _bundle(32, seed=5)
    args = (*_t(wpe, ne, te, b), _port_grid(grid), FREQ, start, kdir, 5e-3,
            201, 10)
    one = trace_rays_segments(*args, seg_records=64, bvec=_t(*bvec),
                              s_mode=s_mode)
    many = trace_rays_segments(*args, seg_records=7, bvec=_t(*bvec),
                               s_mode=s_mode)
    for a, c in zip(one, many):
        np.testing.assert_array_equal(a, c)


def test_segment_plan_runs_no_step_past_the_last_record():
    plan, n_rec = segment_plan(650, 10, 64)
    assert n_rec == 65 and plan == [(1, 64), (10, 1)]
    steps = sum(nf + (rps - 1) * 10 for nf, rps in plan)
    assert steps == 1 + (n_rec - 1) * 10
    assert segment_plan(201, 10, 7) == (
        [(1, 7), (10, 7), (10, 7)], 21)


@pytest.mark.parametrize("crosssections", [True, False])
def test_trace_rays_twin_matches_jax(crosssections):
    grid, wpe, *_ = _scene()
    start, kdir = _bundle(48, seed=2)
    table_j = jtracer.pack_trace_table(jnp.asarray(wpe), grid)
    table_p = tracer.pack_trace_table(torch.as_tensor(wpe), _port_grid(grid))
    np.testing.assert_allclose(table_p.numpy(), np.asarray(table_j),
                               rtol=1e-6, atol=1e-6 * float(wpe.max()))
    k0_j = jtracer.init_k_vectors(table_j, grid, FREQ, start, kdir)
    k0_p = tracer.init_k_vectors(table_p, _port_grid(grid), FREQ,
                                 *_t(start, kdir))
    np.testing.assert_allclose(k0_p.numpy(), np.asarray(k0_j), rtol=1e-6)
    kw = dict(trace_crosssections=crosssections, first_block=3,
              record_k=True)
    res_j = jtracer.trace_rays(table_j, grid, FREQ, jnp.asarray(start),
                               jnp.asarray(kdir), 5e-3, 33, 10,
                               k_init=k0_j * 0.99, **kw)
    res_p = tracer.trace_rays(table_p, _port_grid(grid), FREQ,
                              *_t(start, kdir), 5e-3, 33, 10,
                              k_init=k0_p * 0.99, **kw)
    for a, c, rtol in zip(res_p, res_j, (2e-4, 5e-3, 2e-4, 2e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=rtol,
                                   atol=rtol)


@pytest.mark.parametrize("crosssections", [True, False])
def test_per_step_records_match_xla(crosssections):
    """s_mode='per_step' through tracer_segments (three segments, the
    plain version on the CPU) against the JAX XLA tracer's per-step
    records, on the refracting bundle with frozen rays, at the tolerances
    of the cumulative tests; row 3 differs from the cumulative records,
    and is 1 with cross-sections off as in JAX (tracer.py:283-284)."""
    grid, wpe, ne, te, b, _ = _scene()
    start, kdir = _bundle(128, seed=4)
    start[:3, 0] = 50.0
    res, res_x, _ = _compare(grid, wpe, ne, te, b, start, kdir, dt=5e-3,
                             n_steps=71, stride=10, seg_records=3,
                             s_mode="per_step", crosssections=crosssections)
    if not crosssections:
        np.testing.assert_array_equal(res.s_record, 1.0)
        return
    cum = trace_rays_segments(*_t(wpe, ne, te, b), _port_grid(grid), FREQ,
                              start, kdir, 5e-3, 71, 10, seg_records=3)
    np.testing.assert_array_equal(res.r_record, cum.r_record)
    live = res.s_record[-1] > 0
    assert live.sum() > 100
    assert np.mean(res.s_record[1:, live] != cum.s_record[1:, live]) > 0.9
    np.testing.assert_array_equal(res.s_record[0], cum.s_record[0])


def test_per_step_segment_carries_cumulative_s():
    """In per-step mode the segment's end state is the cumulative one: r
    and k match the JAX tracer's final state, and row 6 holds the running
    product, which equals the cumulative segment's and JAX's last
    cumulative record; so a continued segment does not depend on the
    mode."""
    grid, wpe, ne, te, b, _ = _scene()
    g = _port_grid(grid)
    start, kdir = _bundle(64, seed=6)
    tcube, scube = prepare_trace_inputs(*_t(wpe, ne, te, b), g)
    k0 = tracer.init_k_vectors(tcube.reshape(-1, 4), g, FREQ,
                               *_t(start, kdir))
    state = torch.cat([torch.as_tensor(start).T, k0.T,
                       torch.ones(1, 64)]).contiguous()
    args = (tcube, scube, state, g, 5e-3, 1, 10, 5)
    st_ps, rec_ps = trace_segment(*args, s_mode="per_step")
    st_cu, rec_cu = trace_segment(*args)
    torch.testing.assert_close(st_ps, st_cu, rtol=0, atol=0)
    torch.testing.assert_close(rec_ps[:, [0, 1, 2, 4, 5, 6, 7]],
                               rec_cu[:, [0, 1, 2, 4, 5, 6, 7]], rtol=0,
                               atol=0)
    table = jtracer.pack_trace_table(jnp.asarray(wpe), grid)
    res_x = jtracer.trace_rays(table, grid, FREQ, jnp.asarray(start),
                               jnp.asarray(kdir), 5e-3, 41, 10,
                               trace_crosssections=True)
    np.testing.assert_allclose(st_ps[:6].T.numpy(),
                               np.asarray(res_x.final_state), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st_ps[6].numpy(),
                               np.asarray(res_x.s_record[-1]), rtol=5e-3,
                               atol=5e-4)
    with pytest.raises(ValueError, match="s_mode"):
        trace_segment(*args, s_mode="instant")


def test_wrapper_dispatches_cpu_to_plain_and_checks_inputs():
    grid, wpe, ne, te, b, _ = _scene(n=9)
    g = _port_grid(grid)
    tcube, scube = prepare_trace_inputs(*_t(wpe, ne, te, b), g)
    assert tcube.shape == (9, 9, 9, 4) and scube.shape == (9, 9, 9, 4)
    np.testing.assert_array_equal(scube[..., 3].numpy(), 0.0)
    start, kdir = _bundle(8)
    state = torch.cat([torch.as_tensor(start).T,
                       torch.as_tensor(kdir).T * 1e8,
                       torch.ones(1, 8)]).contiguous()
    args = (tcube, scube, state, g, 5e-3, 1, 10, 2)
    launches = trace_segment.launches
    out_w = trace_segment(*args)
    out_p = trace_segment_plain(*args)
    assert trace_segment.launches == launches   # no kernel on the CPU
    for a, c in zip(out_w, out_p):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    assert out_w[1].shape == (2, 8, 8) and out_w[0].shape == (7, 8)
    with pytest.raises(TypeError, match="float32"):
        trace_segment(tcube.double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        trace_segment(tcube, scube, state.T.contiguous().T, *args[3:])
    with pytest.raises(ValueError, match="scube shape"):
        trace_segment(tcube, scube[..., :3].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="state must be"):
        trace_segment(tcube, scube, state[:6].contiguous(), *args[3:])
    with pytest.raises(ValueError, match=">= 1"):
        trace_segment(*args[:5], 0, 10, 2)


# grids of the trace-input tests: a cube, a non-cubic grid with distinct
# steps, and an axis of two nodes
PACK_GRIDS = {
    "cube": UniformGrid(-2.0, -2.0, -2.0, 0.5, 0.5, 0.5, 9, 9, 9),
    "odd": UniformGrid(-1.0, 0.5, 2.0, 0.31, 0.17, 0.023, 7, 5, 3),
    "axis_of_two": UniformGrid(0.0, 0.0, 0.0, 0.1, 0.2, 0.3, 6, 2, 11)}


def _pack_fields(shape, dtype, seed=0):
    """omega_pe, ne, te, b and three B components, random, with a 0, an
    inf and a NaN in omega_pe."""
    rng = np.random.default_rng(seed)
    cubes = [torch.as_tensor(rng.uniform(0.5, 2.0, shape) * scale, dtype=dtype)
             for scale in (3e8, 1e8, 1e6, 10.0, 5.0, -3.0, 1.0)]
    cubes[0].view(-1)[:3] = torch.tensor([0.0, np.inf, np.nan], dtype=dtype)
    return cubes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [4, 8])
@pytest.mark.parametrize("grid_name", sorted(PACK_GRIDS))
def test_pack_trace_inputs_runs_the_plain_stack_on_the_cpu(grid_name,
                                                           channels, dtype):
    """On CPU tensors pack_trace_inputs (and prepare_trace_inputs through
    it) launches nothing and gives the cubes that prepare_trace_inputs'
    torch ops always made: omega_pe and its np.gradient-style derivatives,
    and [ne, te, b, 0] or [ne, te, b, Bx, By, Bz, 0, 0], float32,
    contiguous, channels last."""
    grid = PACK_GRIDS[grid_name]
    cubes = _pack_fields(grid.shape, dtype)
    bvec = tuple(cubes[4:]) if channels == 8 else None
    launches = pack_trace_inputs.launches
    tcube, scube = pack_trace_inputs(*cubes[:4], grid, bvec)
    assert pack_trace_inputs.launches == launches
    wpe = cubes[0].to(torch.float32)
    want_t = torch.stack([wpe, *tracer.gradient_cubes(wpe, grid)], dim=-1)
    zero = torch.zeros(grid.shape)
    given = cubes[1:4] if channels == 4 else cubes[1:]
    want_s = torch.stack([c.to(torch.float32) for c in given]
                         + [zero] * (channels - len(given)), dim=-1)
    for got, want in ((tcube, want_t), (scube, want_s)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tcube.shape == (*grid.shape, 4)
    assert scube.shape == (*grid.shape, channels)
    assert torch.isinf(tcube[0, 0, 0, 3]) and torch.isnan(tcube[0, 0, 2, 1])
    for got, want in zip(prepare_trace_inputs(*cubes[:4], grid, bvec),
                         (tcube, scube)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


PACK_FAULTS = {
    "omega_pe_shape": ("cube shape", lambda c, g: ([c[0][:, :-1]] + c[1:], g)),
    "ne_shape": ("cube shape", lambda c, g: (c[:1] + [c[1][:-1]] + c[2:], g)),
    "b_shape": ("cube shape", lambda c, g: (
        c[:3] + [c[3].permute(2, 1, 0)] + c[4:], g)),
    "bvec_shape": ("cube shape", lambda c, g: (c[:6] + [c[6][..., 1:]], g)),
    "bvec_of_two": ("3 cubes", lambda c, g: (c[:6], g)),
    "x_of_one": (">= 2 nodes", lambda c, g: (
        [x[:1] for x in c], UniformGrid(0, 0, 0, 0.1, 0.1, 0.1, 1, 4, 5))),
    "y_of_one": (">= 2 nodes", lambda c, g: (
        [x[:, :1] for x in c], UniformGrid(0, 0, 0, 0.1, 0.1, 0.1, 3, 1, 5))),
    "z_of_one": (">= 2 nodes", lambda c, g: (
        [x[..., :1] for x in c], UniformGrid(0, 0, 0, 0.1, 0.1, 0.1, 3, 4, 1))),
    "mixed_devices": ("is on", lambda c, g: (
        c[:2] + [c[2].to("meta")] + c[3:], g)),
    "no_kernel_device": ("no trace-input kernel", lambda c, g: (
        [x.to("meta") for x in c], g)),
}


@pytest.mark.parametrize("fault", sorted(PACK_FAULTS))
def test_pack_trace_inputs_refuses_cubes_it_cannot_pack(fault):
    """A cube whose shape is not the grid's, a B vector of other than three
    cubes, an axis of fewer than two nodes, cubes on two devices or on a
    device with no kernel each raise ValueError before anything runs."""
    grid = UniformGrid(0, 0, 0, 0.1, 0.1, 0.1, 3, 4, 5)
    match, make = PACK_FAULTS[fault]
    cubes, grid = make(_pack_fields(grid.shape, torch.float32), grid)
    launches = pack_trace_inputs.launches
    with pytest.raises(ValueError, match=match):
        pack_trace_inputs(*cubes[:4], grid, tuple(cubes[4:]))
    assert pack_trace_inputs.launches == launches


def test_exact_build_only_adds_fmad_false_and_no_build_loosens_ieee():
    """The one build (NVCC_FLAGS) is exact: without FMA contraction
    (-fmad=false) it rounds as the plain version's separate torch ops do,
    and the CUDA tests hold it to the plain version bit for bit. No flag
    loosens IEEE division, square root, denormals or contraction, and
    build_library takes no flags of its own."""
    import inspect
    from raytracinggrff_tpu_torch.ops._build import NVCC_FLAGS, build_library
    assert [f for f in NVCC_FLAGS if "fmad" in f] == ["-fmad=false"]
    assert not inspect.signature(build_library).parameters
    loose = {"--use_fast_math", "-use_fast_math", "-ftz=true", "--ftz=true",
             "-prec-div=false", "--prec-div=false", "-prec-sqrt=false",
             "--prec-sqrt=false", "-fmad=true", "--fmad=true"}
    assert not loose & set(NVCC_FLAGS)


@pytest.mark.parametrize("n,channels,wide", [
    (576, 8, False), (1024, 4, False), (1024, 8, True), (1291, 4, True)])
def test_wide_index_only_for_cubes_of_2_31_float4(n, channels, wide):
    """The kernel's cube offsets count float4 elements: 32-bit ones reach
    the sample cube's last element below 2^31 of them (a 576^3 x 8-channel
    cube holds 3.8e8), 64-bit ones above."""
    from raytracinggrff_tpu_torch.ops.trace_segment import needs_wide_index
    assert needs_wide_index(n ** 3, channels) is wide


def _inside(r, grid):
    """Whether each column of r (3, n) lies in the cube, as the kernel's
    locate decides it (NaN is outside)."""
    lo = torch.tensor(grid.origin, dtype=torch.float32)[:, None]
    inv = torch.tensor(grid.inv_steps, dtype=torch.float32)[:, None]
    top = torch.tensor(grid.shape, dtype=torch.float32)[:, None] - 1
    f = (r - lo) * inv
    return ((f >= 0) & (f <= top)).all(dim=0)


@pytest.mark.parametrize("channels", [4, 8])
@pytest.mark.parametrize("crosssections", [True, False])
@pytest.mark.parametrize("s_mode", ["cumulative", "per_step"])
@pytest.mark.parametrize("kind", ["outside", "nan_position", "nan_k",
                                  "negative_zero", "leaving"])
def test_frozen_ray_step_is_a_fixed_point(kind, s_mode, crosssections,
                                          channels):
    """The premise of the trace kernel's exit: once a ray is outside the
    cube or its k has a non-finite component, within two steps a step of
    the plain version returns (r, k) bit for bit, with a ratio of +0 or
    NaN (the per-step S; the cumulative S is then +0 or NaN too), and it
    keeps doing so for every step that follows."""
    grid, wpe, ne, te, b, bvec = _scene(n=33)
    g = _port_grid(grid)
    tcube, scube = prepare_trace_inputs(
        *_t(wpe, ne, te, b), g, _t(*bvec) if channels == 8 else None)
    n_steps = 6
    if kind == "leaving":      # heading +x, out at staggered steps 1-48
        n, n_steps = 64, 52
        start = np.column_stack([np.linspace(1.90, 1.999, n),
                                 np.full(n, 0.3), np.full(n, 0.5)])
        kdir = np.tile([[1.0, 0.0, 0.0]], (n, 1))
    else:
        start, kdir = _bundle(8, seed=4)
    start, kdir = start.astype(np.float32), kdir.astype(np.float32)
    if kind == "outside":
        start[:, 0] = np.linspace(2.5, 50.0, 8)
    elif kind == "nan_position":
        start[::2, 0] = np.nan
        start[1::2] = np.nan
    elif kind == "negative_zero":    # x = -0.0, z outside the cube
        start[:, 0] = -0.0
        start[:, 2] = np.linspace(2.1, 9.0, 8)
    k0 = tracer.init_k_vectors(tcube.reshape(-1, 4), g, FREQ,
                               *_t(start, kdir))
    if kind == "nan_k":              # inside the cube, k not finite
        k0[:, 0] = np.nan
        k0[4:, 1] = np.inf
        k0[6:, 2] = -0.0
    state = torch.cat([torch.as_tensor(start).T, k0.T,
                       torch.ones(1, start.shape[0])]).contiguous()
    states, ratios = [state], []
    for _ in range(n_steps):
        state, rec = trace_segment_plain(tcube, scube, state, g, 5e-3, 1, 1,
                                         1, 2.0, crosssections, s_mode)
        states.append(state)
        ratios.append(rec[0, 3])
    if kind == "negative_zero":      # the first step turns -0 into +0
        assert torch.signbit(states[0][0]).all()
        assert not torch.signbit(states[1][0]).any()
    bits = torch.stack(states).view(torch.int32)           # (n+1, 7, rays)
    ratios = torch.stack(ratios)
    gone = torch.stack([~_inside(s[0:3], g)
                        | ~torch.isfinite(s[3:6]).all(dim=0)
                        for s in states])
    assert gone.any(dim=0).all()
    for ray in range(bits.shape[2]):
        t = int(torch.nonzero(gone[:, ray])[0])
        assert t + 2 <= n_steps, (ray, t)
        # steps t + 2, t + 3, ... map states[j] to states[j + 1] for j > t
        for j in range(t + 1, n_steps):
            assert torch.equal(bits[j + 1, :, ray], bits[j, :, ray]), (ray, j)
            s = ratios[j, ray]
            if crosssections:
                assert s.view(torch.int32) == 0 or torch.isnan(s), (ray, j)
            else:
                assert s == 1.0
    if kind == "leaving":
        left = [int(torch.nonzero(gone[:, r])[0]) for r in range(64)]
        assert min(left) <= 2 and max(left) >= 40
