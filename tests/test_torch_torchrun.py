"""make_mesh's torchrun path: the README's multi-device example, run by
`python -m torch.distributed.run --standalone --nproc-per-node 2` with
devices=["cpu", "cpu"], joins its group through the env:// rendezvous and
gives the one-process map. --standalone picks a free port, so parallel test
workers do not collide."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from raytracinggrff_tpu_torch.parallel.dryrun import small_map
from raytracinggrff_tpu_torch.pipeline import run_ray_tracing_emission

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
# the bar of chip_smoke.py phase 12 on a mesh map against one process
TB_RTOL, VI_ATOL = 1e-6, 1e-6

SCRIPT = """\
import sys
import numpy as np
import torch.distributed as dist
from raytracinggrff_tpu_torch import make_mesh, run_ray_tracing_emission
from raytracinggrff_tpu_torch.parallel.dryrun import small_map

cubes, cfg = small_map(nfreq=2)
mesh = make_mesh(n_ray_shards=2, devices=["cpu", "cpu"])
result = run_ray_tracing_emission(cubes=cubes, config=cfg, mesh=mesh,
                                  device="cpu", verbose=False)
np.savez(f"{sys.argv[1]}/rank{mesh.rank}.npz",
         emission_cube=result["emission_cube"],
         emission_polVI_cube=result["emission_polVI_cube"],
         shape=mesh.shape, world=dist.get_world_size(),
         backend=dist.get_backend())
dist.destroy_process_group()
"""


def test_torchrun_two_ranks_equal_one_process(tmp_path):
    script = tmp_path / "emission.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cubes, cfg = small_map(nfreq=2)
    one = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                   device="cpu")
    for rank in (0, 1):
        out = np.load(tmp_path / f"rank{rank}.npz")
        assert tuple(out["shape"]) == (2, 1) and int(out["world"]) == 2
        assert str(out["backend"]) == "gloo"
        tb, vi = out["emission_cube"], out["emission_polVI_cube"]
        assert tb.shape == (8, 8, 2) and np.all(np.isfinite(tb))
        np.testing.assert_allclose(tb, one["emission_cube"], rtol=TB_RTOL,
                                   atol=0)
        np.testing.assert_allclose(vi, one["emission_polVI_cube"],
                                   rtol=0, atol=VI_ATOL)
