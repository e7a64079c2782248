"""The port imports neither JAX nor the JAX package, and its training
harness and host layers (I/O, codecs, the presentation mixins, ``post``,
``preference``) have the JAX package's names.

A fresh interpreter, with ``jax``, ``jaxlib`` and ``audiotools_tpu`` refused
by a ``sys.meta_path`` finder, imports every module of
``audiotools_tpu_torch`` (found by walking the package on disk, so a new
module is covered without a change here). Those modules' public
names and signatures are compared with the JAX package's through their
syntax trees (nothing of the JAX package is imported); the lists below are
the deliberate differences.
"""
import ast
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
    "audiotools_tpu_torch.ml.layers.base", "audiotools_tpu_torch.models.streaming",
    "audiotools_tpu_torch.models.artifacts", "audiotools_tpu_torch.metrics._pesq",
    "audiotools_tpu_torch.metrics.quality", "audiotools_tpu_torch.ops.stoi",
    "audiotools_tpu_torch.ops.pesq", "audiotools_tpu_torch.ops.nsim",
    "audiotools_tpu_torch._hostprof", "audiotools_tpu_torch.ml.accelerator",
    "audiotools_tpu_torch.ml.checkpoint", "audiotools_tpu_torch.ml.decorators",
    "audiotools_tpu_torch.ml.experiment", "audiotools_tpu_torch.ml.profiling",
    "audiotools_tpu_torch.examples.train_dac", "audiotools_tpu_torch.io.codecs",
    "audiotools_tpu_torch.io.amrnb", "audiotools_tpu_torch.native",
    "audiotools_tpu_torch.core.ffmpeg", "audiotools_tpu_torch.core.display",
    "audiotools_tpu_torch.core.playback", "audiotools_tpu_torch.core.whisper",
    "audiotools_tpu_torch.post", "audiotools_tpu_torch.preference",
])
def test_module_list_covers_the_new_modules(module):
    assert module in MODULES


def test_every_module_imports_without_jax():
    done = subprocess.run([sys.executable, "-c", PROBE, *MODULES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip() == str(len(MODULES))


# the harness and host-layer modules: names only in the port or only in the
# JAX package, and signatures that differ
HARNESS = ["ml/__init__.py", "ml/accelerator.py", "ml/checkpoint.py", "ml/decorators.py",
           "ml/experiment.py", "ml/profiling.py", "_hostprof.py", "io/__init__.py",
           "io/codecs.py", "io/amrnb.py", "io/wav.py", "native/__init__.py", "core/ffmpeg.py",
           "core/display.py", "core/playback.py", "core/whisper.py", "post.py", "preference.py"]
PORT_ONLY = {
    # the step folders' file names, and the complete steps on disk
    "ml/checkpoint.py": {"HOST_FILE", "STATE_FILE", "Checkpointer.steps"},
    # the libav probe compiles a test program in a temporary directory
    "native/__init__.py": {"tempfile"},
}
JAX_ONLY = {
    # imported and unused by the JAX package's module (an ``__init__``, so
    # its imports count as its names)
    "native/__init__.py": {"os"},
}
SIGNATURES = {
    # a device instead of a mesh and its data axis
    "Accelerator.__init__": (("self", "amp", "mesh", "data_axis"), ("self", "amp", "device")),
    # a module instead of a parameter tree; DistributedDataParallel's options
    "Accelerator.prepare_model": (("self", "params", "rules"),
                                  ("self", "model", "rules", "**kwargs")),
    # the optimizer, stepped as torch's GradScaler steps it, instead of a callable
    "Accelerator.step": (("self", "optimizer_step", "*args", "**kwargs"), ("self", "optimizer")),
    # torch.profiler has no host tracer level
    "trace": (("log_dir", "host_tracer_level"), ("log_dir",)),
    # the native meter's device (the card unless told otherwise)
    "r128stats": (("filepath", "quiet"), ("filepath", "quiet", "device")),
}


def _public(name):
    return all(not part.startswith("_") or part.startswith("__") for part in name.split("."))


def _surface(path):
    """Public top-level names and class methods, each with its parameter
    names (None for a value); imported names count where they are
    re-exported (a package's ``__init__``, or listed in ``__all__``)."""
    out, imported, exported = {}, set(), set()

    def params(fn):
        a = fn.args
        return (tuple(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)
                + ((f"*{a.vararg.arg}",) if a.vararg else ())
                + ((f"**{a.kwarg.arg}",) if a.kwarg else ()))

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = params(sub)
        elif isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                exported = set(ast.literal_eval(node.value))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0] for a in node.names}
    if path.name == "__init__.py":
        exported = imported
    out.update({name: None for name in imported & exported})
    return {k: v for k, v in out.items() if _public(k)}


@pytest.mark.parametrize("module", HARNESS)
def test_harness_has_the_jax_packages_names(module):
    jax_names = _surface(ROOT / "audiotools_tpu" / module)
    port_names = _surface(ROOT / "audiotools_tpu_torch" / module)
    assert set(jax_names) - set(port_names) == JAX_ONLY.get(module, set())
    assert set(port_names) - set(jax_names) == PORT_ONLY.get(module, set())
    for name in sorted(set(jax_names) & set(port_names)):
        if jax_names[name] != port_names[name]:
            assert SIGNATURES.get(name) == (jax_names[name], port_names[name]), name
