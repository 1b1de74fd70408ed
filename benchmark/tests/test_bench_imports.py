"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from bench_util import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "compound_ray_tpu"}

RUN = r"""
import json, sys
sys.path.insert(0, {tests!r})
from bench_util import small_root, run_small
import benchmark.run, benchmark.control, benchmark.harness
res = run_small(small_root({tmp!r}), "small.sweep", seconds=0.3)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
import numpy as np
from benchmark.reference import Reference
from benchmark.scene import load_plugin
scene = load_plugin("scenes", "boxes_field").build(n_boxes=10, seed=0)
omms = load_plugin("eyes", "sphere_eye").build(n=16, acceptance_deg=5.0)
Reference(scene, "cpu").frame(omms, (0, 2, 0), np.eye(3), 8, 1, 0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax(tmp_path):
    tests = os.path.dirname(os.path.abspath(__file__))
    mods = _modules(RUN.format(tests=tests, tmp=str(tmp_path / "b")))
    assert "compound_ray_tpu_torch" in mods  # the run drove the program
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert "benchmark" in mods
    assert not mods & (FORBIDDEN | {"compound_ray_tpu_torch"})
