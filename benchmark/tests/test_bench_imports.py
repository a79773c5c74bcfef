"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the program's name begins with the JAX
package's); the reference loads nothing of the program."""

import json
import subprocess
import sys

from benchmark.harness import FORBIDDEN, ROOT, forbidden_modules

PROBE = """
import importlib, json, pathlib, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
for path in sorted(pathlib.Path({root!r}, "benchmark", "metrics").glob("*.py")):
    from benchmark.harness import reader
    reader(path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(modules):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            modules=list(modules))],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_drivers_and_harness_load_no_jax():
    loaded = top_level_modules(
        ["benchmark.harness", "benchmark.calibrate", "benchmark.drivers.trace",
         "benchmark.drivers.map", "benchmark.drivers.sweep"])
    assert "raytracinggrff_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_modules(
        ["benchmark.reference.map", "benchmark.reference.presets",
         "benchmark.yardstick.compare", "benchmark.yardstick.roofline",
         "benchmark.yardstick.device_trace", "benchmark.gen.mas"])
    assert not loaded & ({"raytracinggrff_tpu_torch"} | set(FORBIDDEN))


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracinggrff_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]
