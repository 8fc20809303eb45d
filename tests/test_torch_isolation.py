"""The port imports no JAX and nothing of the JAX package.

Checked in a subprocess: the suite's conftest has already imported jax into
this process. There, ``jax`` (with ``jaxlib`` and ``flax``) and
``shapley_vit_tpu`` are blocked in ``sys.modules``, and every module of
``shapley_vit_tpu_torch`` plus ``chip_smoke`` is imported.
"""

import os
import subprocess
import sys

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
    assert int(out.stdout.strip().splitlines()[-1]) >= 25  # every module was imported
