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
from raytracinggrff_tpu_torch.ops.trace_segment import (trace_segment,
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


def test_exact_build_only_adds_fmad_false_and_no_build_loosens_ieee():
    """The shipped build (NVCC_FLAGS) is the exact one: without FMA
    contraction (-fmad=false) it rounds as the plain version's separate
    torch ops do, and the CUDA tests hold it to the plain version bit for
    bit. The FMA build kept for measurement (FMA_NVCC_FLAGS) differs from
    it only by -fmad=false, and neither build loosens IEEE division,
    square root or denormals."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (FMA_NVCC_FLAGS,
                                                            NVCC_FLAGS,
                                                            build_library)
    assert NVCC_FLAGS == FMA_NVCC_FLAGS + ("-fmad=false",)
    assert build_library.__defaults__ == (NVCC_FLAGS,)
    loose = {"--use_fast_math", "-use_fast_math", "-ftz=true",
             "-prec-div=false", "-prec-sqrt=false", "-fmad=true"}
    assert not loose & (set(NVCC_FLAGS) | set(FMA_NVCC_FLAGS))


@pytest.mark.parametrize("n,channels,wide", [
    (576, 8, False), (1024, 4, False), (1024, 8, True), (1291, 4, True)])
def test_wide_index_only_for_cubes_of_2_31_float4(n, channels, wide):
    """The kernel's cube offsets count float4 elements: 32-bit ones reach
    the sample cube's last element below 2^31 of them (a 576^3 x 8-channel
    cube holds 3.8e8), 64-bit ones above."""
    from raytracinggrff_tpu_torch.ops.trace_segment import needs_wide_index
    assert needs_wide_index(n ** 3, channels) is wide
