"""Neither the harness nor the reference loads JAX or the JAX package, and
the reference loads nothing of the program: top-level module names, compared
whole, in fresh processes."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HARNESS = """
from bench_port import harness
bench = harness.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_module("metrics", m["name"])
for w in bench["workloads"]:
    f = harness.cell_files(bench, w["name"])
    harness.load_module("entries", f["traffic"]["entry"])
    harness.load_module("reference/generators", f["config"]["generator"])
import bench_port.calibrate
"""

REFERENCE = """
import bench_port.reference.check
import bench_port.reference.generators.laplacian_27pt as g1
import bench_port.reference.generators.elasticity_beam as g2
g1.generate(3); g2.generate(4, 2, 2)
"""


def top_level_modules(code):
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = top_level_modules(HARNESS)
    assert "amg_tpu_torch" in mods  # the program is loaded: the check is live
    assert not mods & {"jax", "jaxlib", "flax", "amg_tpu"}


def test_reference_loads_neither_jax_nor_the_program():
    mods = top_level_modules(REFERENCE)
    assert "scipy" in mods
    assert not mods & {"jax", "jaxlib", "flax", "amg_tpu", "amg_tpu_torch"}
