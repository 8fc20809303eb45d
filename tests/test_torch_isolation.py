"""The port imports no JAX and nothing of the JAX package.

Checked in a subprocess: the suite's conftest has already imported jax into
this process. There, ``jax`` (with ``jaxlib`` and ``flax``) and
``shapley_vit_tpu`` are blocked in ``sys.modules``, and every module of
``shapley_vit_tpu_torch`` plus ``chip_smoke`` is imported, each new module
of the service and adversarial slices also on its own. The native watcher
the port loads is its own build, never the JAX package's
``csrc/libsvt_runtime.so``.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "shapley_vit_tpu"):
    sys.modules[name] = None
import shapley_vit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(shapley_vit_tpu_torch.__path__, "shapley_vit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, v in sys.modules.items() if v is not None and (m.split(".")[0] in ("jax", "jaxlib", "flax") or m.split(".")[0] == "shapley_vit_tpu"))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 35  # every module was imported


# the service slice's modules, each imported alone in a fresh interpreter
SERVICE_MODULES = [
    "ops.quant", "driver.protocol", "driver.report", "driver.serve", "driver.status",
    "driver.supervisor", "fl.native", "fl.server", "utils.metrics", "utils.tb_events",
]


# the adversarial/interpretability slice's modules
ROBUST_MODULES = ["fl.adversarial", "models.interpret", "models.inception", "models.convert"]


@pytest.mark.parametrize("name", SERVICE_MODULES + ROBUST_MODULES)
def test_service_module_imports_alone_without_jax(name):
    probe = ("import sys\n"
             "for n in ('jax', 'jaxlib', 'flax', 'shapley_vit_tpu'):\n"
             "    sys.modules[n] = None\n"
             f"import shapley_vit_tpu_torch.{name}\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


_NATIVE_PROBE = r"""
import os
from shapley_vit_tpu_torch.fl import ingestion, native
assert native.native_available()
ingestion.wait_for_checkpoints([os.devnull], timeout=0.1, policy="skip")
maps = open("/proc/self/maps").read()
jax_lib = os.path.realpath(os.path.join("csrc", "libsvt_runtime.so"))
assert jax_lib not in maps, "the JAX package's native library was loaded"
assert native._LIB_PATH in maps and "shapley_vit_tpu_torch/build/" in native._LIB_PATH
print(native._LIB_PATH)
"""


def test_port_never_loads_the_jax_native_library():
    out = subprocess.run([sys.executable, "-c", _NATIVE_PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
