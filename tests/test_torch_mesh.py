"""The port's multi-device runs (raytracinggrff_tpu_torch/parallel) on the
CPU, with ranks spawned on gloo: the mirror of tests/test_sharding.py and
tests/test_streamed_pipeline.py:53-74. Mesh maps are held against the
port's one-process map at the JAX mesh test's tolerance and against the
JAX map on the 8-device virtual mesh at the port-vs-JAX tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracinggrff_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracinggrff_tpu.pipeline import (
    RayEmissionConfig as JaxConfig, run_ray_tracing_emission as jax_run)
from raytracinggrff_tpu_torch.parallel import dryrun
from raytracinggrff_tpu_torch.parallel.launch import rank_devices, spawn
from raytracinggrff_tpu_torch.parallel.mesh import (
    RayMesh, check_devices, freq_slice, make_mesh, mesh_layout, rank_coords,
    shard_freqs, shard_rays)
from raytracinggrff_tpu_torch.pipeline import (
    RayEmissionConfig, cubes_from_numpy, run_ray_tracing_emission)

torch.set_num_threads(1)

# the scene of tests/test_streamed_pipeline.py:53-74
COMMON = dict(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40, grid_extent=2.5,
              z_observer=2.5, dt=1e-2, n_steps=310, record_stride=10,
              nfreq=2, freq_log_step=0.2)
CFG = RayEmissionConfig(seg_records=10, **COMMON)


@pytest.fixture(scope="module")
def cubes():
    from raytracinggrff_tpu_torch.grids import UniformGrid
    grid = UniformGrid.cube(2.5, 40)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    return {"omega_pe": (8.93e3 * np.sqrt(ne) * 2 * np.pi).astype(np.float32),
            "ne": ne, "te": np.full_like(ne, 1.4e6),
            "b": (2.0 / np.maximum(r, 0.9) ** 3).astype(np.float32)}


@pytest.fixture(scope="module")
def one_process(cubes):
    return run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                    config=CFG, verbose=False, device="cpu")


@pytest.fixture(scope="module")
def mesh_maps(cubes):
    """The map over each mesh shape, spawned once per shape."""
    runs = {}

    def run(shape):
        if shape not in runs:
            runs[shape] = spawn(dryrun.map_rank, shape[0] * shape[1], "cpu",
                                "gloo", args=(shape, CFG, cubes))
        return runs[shape]
    return run


def test_mesh_layout_without_spawning(monkeypatch):
    """make_mesh's layout and refusals, the twin of test_mesh_shapes."""
    assert mesh_layout(8, 4, 2) == (4, 2)
    assert mesh_layout(8) == (8, 1) and mesh_layout(8, None, 2) == (4, 2)
    with pytest.raises(ValueError):
        mesh_layout(8, 3, 2)
    assert [rank_coords(r, 2) for r in range(8)] == [
        (r // 2, r % 2) for r in range(8)]
    mesh = RayMesh((3, 2), 1, 1, torch.device("cpu"), None)
    assert mesh.axis_names == ("rays", "freq") and mesh.rank == 3
    np.testing.assert_array_equal(shard_rays(np.arange(10), mesh), [1, 4, 7])
    assert freq_slice(4, 2, 1) == slice(2, 4)
    assert freq_slice(3, 2, 1) == slice(0, 3)      # 3 does not split in 2
    np.testing.assert_array_equal(shard_freqs(np.arange(8.0), mesh),
                                  [4, 5, 6, 7])
    assert rank_devices("cuda", 2) == ["cuda:0", "cuda:1"]
    assert rank_devices("cuda:0", 2) == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="gloo"):
        check_devices(["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="CUDA"):
        check_devices(["cpu", "cpu"], "nccl")
    with pytest.raises(ValueError, match="nccl"):
        spawn(dryrun.map_rank, 2, "cpu", "nccl")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="LOCAL_RANK"):
            make_mesh(1, 1)


def test_make_mesh_in_an_existing_group(tmp_path):
    """In a group that exists already (spawn's, or a FileStore group of
    one rank), make_mesh takes the group's backend, not the default of
    its device; gather_rays inverts shard_rays and shard_freqs."""
    import torch.distributed as dist
    from raytracinggrff_tpu_torch.parallel.launch import init_group
    from raytracinggrff_tpu_torch.parallel.mesh import gather_rays
    init_group(tmp_path / "store", 0, 1, "gloo")
    try:
        mesh = make_mesh(1, 1, devices=["cpu"], backend="nccl")
        assert mesh.shape == (1, 1) and mesh.rank == 0
        full = torch.arange(30.0).reshape(10, 3)
        back = gather_rays(shard_freqs(shard_rays(full, mesh), mesh, axis=1),
                           mesh, 10, 3)
        torch.testing.assert_close(back, full)
    finally:
        dist.destroy_process_group()


def test_mesh_refusals_of_the_map(cubes):
    """A mesh that is not a RayMesh raises TypeError, a device that
    contradicts the mesh's raises ValueError, before any work."""
    mesh = RayMesh((1, 1), 0, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="conflicts"):
        run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                 config=CFG, mesh=mesh, device="cuda",
                                 verbose=False)
    with pytest.raises(TypeError, match="RayMesh"):
        run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                 config=CFG, mesh=(2, 1), device="cpu",
                                 verbose=False)


@pytest.mark.parametrize("shape", [(2, 1), (3, 1), (2, 2)])
def test_mesh_map_matches_one_process(one_process, mesh_maps, shape):
    """Every rank returns the whole map, within the tolerance of
    tests/test_streamed_pipeline.py:71-74 of the one-process map; 64 rays
    do not divide by 3, and (2, 2) shards the 2 frequencies."""
    ranks = mesh_maps(shape)
    assert sorted(r["coords"] for r in ranks) == [
        (i, j) for i in range(shape[0]) for j in range(shape[1])]
    for r in ranks:
        np.testing.assert_allclose(r["emission_cube"],
                                   one_process["emission_cube"],
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(r["emission_polVI_cube"],
                                   one_process["emission_polVI_cube"],
                                   atol=1e-5)
        t = r["timings"]
        assert t["segments"] == 4 and t["straggler_factor"] <= 1.3
        assert len(t["shard_live_steps"]) == shape[0]
        assert {"resample", "trace", "transfer", "gather"} <= set(t)
    assert (one_process["emission_cube"] > 1e4).sum() > 20


def test_mesh_map_matches_jax_mesh_map(cubes, mesh_maps):
    """The (2, 1) map against the JAX XLA map on the 8-device virtual
    mesh, at the port-vs-JAX bar of tests/test_torch_pipeline.py:49-58."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ref = jax_run(cubes={k: jnp.asarray(v) for k, v in cubes.items()},
                  verbose=False, mesh=jax_make_mesh(8, 1),
                  config=JaxConfig(tracer_backend="xla", **COMMON))
    port = mesh_maps((2, 1))[1]
    a, b = ref["emission_cube"], port["emission_cube"]
    lit = (a > 1e4) & (b > 1e4)
    assert lit.sum() > 20
    np.testing.assert_allclose(b[lit], a[lit], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"][lit],
                               ref["emission_polVI_cube"][lit], atol=1e-4)


def test_limb_concentrated_shard_balance():
    """The limb-concentrated scene of tests/test_sharding.py:58-110 over 4
    ray shards: ray i on shard i mod 4 keeps the live steps balanced
    (straggler factor <= 1.3, the VERDICT bound), most shards carry work,
    and every ray's records equal the one-process records."""
    common = dryrun.segment_scene(n_steps=41, seg_records=2)
    start = dryrun.limb_rays(np.random.default_rng(3))
    ranks = spawn(dryrun.scenes_rank, 4, "cpu", "gloo",
                  args=((4, 1), common, [start]))
    recs_1 = dryrun.trace_scene(common, start, "cpu")
    recs_m = np.empty_like(recs_1)
    for i, ((recs, stats),) in enumerate(ranks):
        recs_m[:, :, i::4] = recs
    live = np.asarray(stats["shard_live_steps"])
    assert live.sum() > 0 and stats["straggler_factor"] <= 1.3, live
    assert int((live > 0).sum()) >= 3, live.tolist()
    np.testing.assert_allclose(recs_m[:, 0:4], recs_1[:, 0:4], rtol=1e-5,
                               atol=1e-5)


def test_dryrun_multichip_on_cpu():
    """Both parts of the JAX dry run over a (2, 2) mesh of CPU ranks."""
    summary = dryrun.dryrun_multichip(4, device="cpu", verbose=False)
    assert summary["mesh"] == (2, 2) and len(summary["ranks"]) == 4
    assert summary["straggler_factor"] <= 1.3
    assert summary["max_abs_vi"] <= dryrun.VI_ATOL
