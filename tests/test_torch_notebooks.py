"""The torch twins of the three notebooks (notebooks/torch_*.ipynb): each
runs its code cells on the CPU and gives the arrays of its JAX notebook,
run the same way (IPython % lines dropped, matplotlib on Agg, plt.show a
no-op). Records to the bars of test_trace_rays_from_cube_matches_jax
(tests/test_torch_api.py:80-83): positions rtol/atol 1e-5, S rtol 5e-3
and atol 5e-4; on these scenes every ray holds them to its last record
(18 rays x 1200 steps at 75 MHz, 5 rays x 600 steps at 60 MHz), so no
record is left out. The z grid to 1e-12."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
NOTEBOOKS = Path(__file__).resolve().parent.parent / "notebooks"
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax\b|raytracinggrff_tpu\b"
                        r"(?!_torch))", re.MULTILINE)
# (name, arrays held, their bars as (rtol, atol))
CASES = [
    ("ray_tracing_demo", {"r_rec": (1e-5, 1e-5), "s_rec": (5e-3, 5e-4)}),
    ("cross_section_plots", {"r_rec": (1e-5, 1e-5), "s_rec": (5e-3, 5e-4)}),
    ("z_grid", {"z_irr": (1e-12, 1e-12), "dz_irr": (1e-12, 1e-12)}),
]


def _code_cells(path):
    cells = json.loads(path.read_text())["cells"]
    return ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]


def _run(path, monkeypatch):
    """Exec the notebook's code cells in one namespace and return it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    ns = {}
    for source in _code_cells(path):
        code = "\n".join(line for line in source.splitlines()
                         if not line.startswith("%"))
        exec(compile(code, str(path), "exec"), ns)
    plt.close("all")
    return ns


@pytest.mark.parametrize("name,bars", CASES, ids=[c[0] for c in CASES])
def test_torch_notebook_matches_jax_notebook(name, bars, monkeypatch):
    port = _run(NOTEBOOKS / f"torch_{name}.ipynb", monkeypatch)
    ref = _run(NOTEBOOKS / f"{name}.ipynb", monkeypatch)
    assert port["device"] == "cpu"
    for key, (rtol, atol) in bars.items():
        a, b = port[key], np.asarray(ref[key])
        if isinstance(a, torch.Tensor):      # left on its device, as JAX's
            a = a.cpu().numpy()
        assert a.shape == b.shape, key
        assert np.all(np.isfinite(a)), key
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=key)
    if "r_rec" in bars:
        assert np.ptp(port["r_rec"][:, :, 0]) > 0.5       # the rays bend


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_torch_notebook_form(name):
    """Beside its JAX notebook, the same cells, no outputs, the port
    imported and jax not, and its device named in its first code cell."""
    path = NOTEBOOKS / f"torch_{name}.ipynb"
    nb = json.loads(path.read_text())
    ref = json.loads((NOTEBOOKS / f"{name}.ipynb").read_text())
    assert [c["cell_type"] for c in nb["cells"]] == [
        c["cell_type"] for c in ref["cells"]]
    code = _code_cells(path)
    assert all(not c["outputs"] and c["execution_count"] is None
               for c in nb["cells"] if c["cell_type"] == "code")
    assert not any(JAX_IMPORT.search(c) for c in code)
    assert "from raytracinggrff_tpu_torch." in code[0]
    assert re.search(r'^device = "cpu"\s+# .*"cuda"', code[0], re.MULTILINE)
