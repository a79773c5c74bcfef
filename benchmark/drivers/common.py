"""What the drivers share: the seeded scene written as a MAS directory,
the configuration's map settings, the seeded samples the check compares."""

from __future__ import annotations

import numpy as np

from ..gen.mas import mas_arrays, seed_rng, write_mas_dir

# the cubes of a map's .npz: T_b and V/I
KEYS = ("emission_cube", "emission_polVI_cube")


def write_scene(cell, seed, workdir):
    """The seeded MAS fields and mesh of the cell's scene, written as a
    MAS directory under `workdir`: (arrays, mesh, directory)."""
    from ..harness import lap
    scene = cell.config["scene"]
    arrays, mesh = mas_arrays(scene, seed)
    path = write_mas_dir(workdir / "corona", arrays, mesh, scene["timestep"])
    lap("seeded MAS model written")
    return arrays, mesh, path


def map_settings(cell):
    """The configuration's map settings (RayEmissionConfig fields), with
    the traffic's overrides."""
    run = dict(cell.config["map"])
    run.update(cell.traffic.get("map", {}))
    return run


def sample(seed, n, k):
    """k distinct indices of range(n), sorted, drawn from the seed."""
    rng = seed_rng(seed, 1)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def limits(cell):
    """{number: limit} of the cell's comparison."""
    return dict(cell.traffic["check"]["limits"])
