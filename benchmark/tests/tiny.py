"""Tiny versions of the cells, for runs on the CPU: the same drivers,
readers and reference at sizes a test can hold."""

from __future__ import annotations

import contextlib

from benchmark.harness import Cell

TINY_SCENE = dict(nphi=16, ntheta=12, nr=14)
TINY_MAP = dict(grid_n=24, n_steps=200, dt=2e-2, n_pix=8, seg_records=8)
# a preset of every sweep map at the tiny size
TINY_PRESET = dict(grid_n=24, grid_extent=2.5, z_observer=2.5, x_fov=1.3,
                   dt=1e-2, n_steps=1300, record_stride=20)


def tiny_cell(name, bench_path=None):
    """The cell `name` cut to a tiny scene, map and sample."""
    cell = Cell(name, bench_path)
    cell.config["scene"].update(TINY_SCENE)
    if "map" in cell.config:
        cell.config["map"].update(TINY_MAP)
        cell.traffic.setdefault("map", {})["n_pix"] = TINY_MAP["n_pix"]
    if "sweep" in cell.config:
        cell.config["sweep"].update(n_pix=8, n_freq=2, exact_presets=True)
    check = cell.traffic["check"]
    for key in ("rays", "pixels"):
        if key in check:
            check[key] = 16
    if "maps" in check:
        check["maps"] = 1
    return cell


@contextlib.contextmanager
def tiny_sweep_presets(monkeypatch):
    """Every sweep map at TINY_PRESET, in the program and the reference."""
    import raytracinggrff_tpu_torch.cli.tb_spectra as program
    import benchmark.reference.presets as reference
    monkeypatch.setattr(program, "select_params", lambda f: dict(TINY_PRESET))
    monkeypatch.setattr(reference, "select_params",
                        lambda f: dict(TINY_PRESET))
    yield
