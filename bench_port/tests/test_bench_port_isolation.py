"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's)."""

import os
import subprocess
import sys

from bench_port.lib import cell
from conftest import ROOT

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "shapley_vit_tpu"):
    sys.modules[name] = None
sys.path.insert(0, ROOT)
sys.path.insert(0, ROOT + "/bench_port/tests")
import bench_port
for m in pkgutil.walk_packages(bench_port.__path__, "bench_port."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from bench_port.lib import cell
import glob, os
for path in glob.glob(ROOT + "/bench_port/metrics/*.py"):
    cell.metric_reader(os.path.basename(path)[:-3])
from conftest import tiny_context, run_tiny
for w in ("vitb16-n3", "vitb16-train-b64"):
    run_tiny(tiny_context(w, trace=True))
leaked = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "shapley_vit_tpu"))
assert not leaked, leaked
assert cell.forbidden_loaded() == []
assert "shapley_vit_tpu_torch" in sys.modules
print("ok")
"""


def test_benchmark_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_forbidden_names_are_whole_top_level_names():
    mods = {"shapley_vit_tpu_torch": 1, "shapley_vit_tpu_torch.ops": 1, "jax_like": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert cell.forbidden_loaded(mods) == []
    mods.update({"shapley_vit_tpu.ops": 1, "jaxlib": 1, "flax.linen": 1, "jax": None})
    assert cell.forbidden_loaded(mods) == ["flax.linen", "jaxlib", "shapley_vit_tpu.ops"]
