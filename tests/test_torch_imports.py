"""The port imports neither JAX nor the JAX package.

A fresh interpreter, with ``jax``, ``jaxlib`` and ``audiotools_tpu`` refused
by a ``sys.meta_path`` finder, imports every module of
``audiotools_tpu_torch`` (found by walking the package on disk, so a new
module is covered without a change here).
"""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "audiotools_tpu_torch").rglob("*.py")
)

PROBE = """
import importlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "audiotools_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
for module in sys.argv[1:]:
    importlib.import_module(module)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(sys.argv) - 1)
"""


@pytest.mark.parametrize("module", [
    "audiotools_tpu_torch.core._dsp", "audiotools_tpu_torch.ml",
    "audiotools_tpu_torch.ml.layers.spectral_gate", "audiotools_tpu_torch.data.transforms",
    "audiotools_tpu_torch.data.preprocess", "audiotools_tpu_torch.data.datasets",
    "audiotools_tpu_torch.data.loader", "audiotools_tpu_torch.core.util",
    "audiotools_tpu_torch.core.signal", "audiotools_tpu_torch.core._effects",
    "audiotools_tpu_torch.io", "audiotools_tpu_torch.io.wav", "audiotools_tpu_torch.ops.fft",
    "audiotools_tpu_torch.ops.filters", "audiotools_tpu_torch.ops.resample",
])
def test_module_list_covers_the_new_modules(module):
    assert module in MODULES


def test_every_module_imports_without_jax():
    done = subprocess.run([sys.executable, "-c", PROBE, *MODULES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip() == str(len(MODULES))
