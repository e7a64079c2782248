"""The port imports neither JAX nor the JAX package, and every module of it
has the JAX package's names.

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
    "audiotools_tpu_torch.parallel", "audiotools_tpu_torch.parallel.mesh",
    "audiotools_tpu_torch.parallel.timeshard", "audiotools_tpu_torch.parallel.signal_api",
    "audiotools_tpu_torch.examples.codec", "audiotools_tpu_torch.examples.abx",
    "audiotools_tpu_torch.examples.mushra", "audiotools_tpu_torch.parallel.tensor",
    "audiotools_tpu_torch.ops.perf", "audiotools_tpu_torch.ops.benchmark",
])
def test_module_list_covers_the_new_modules(module):
    assert module in MODULES


def test_every_module_imports_without_jax():
    done = subprocess.run([sys.executable, "-c", PROBE, *MODULES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip() == str(len(MODULES))


# every module pair: the JAX package's modules and their twins in the port.
# Not ported: the Pallas kernels (the port's are csrc/) and an empty package
# marker of the templates folder. ops/benchmark.py and ops/perf.py are
# compared; what they hold of the TPU's workarounds is not ported and is not
# in their public surface: the timers' jitted ``_timed_loop`` (a fori_loop
# with a perturbed carry; the port's timers run eager calls), the upload-cap
# reasoning, and the v5e ceilings (the port's are the H100's, same names).
# ``xla_cost`` keeps its signature but counts what a call dispatches, and
# raises where the JAX version returned zeros.
NOT_PORTED = {"ops/pallas_kernels.py", "core/templates/__init__.py"}
PAIRS = sorted(str(p.relative_to(ROOT / "audiotools_tpu"))
               for p in (ROOT / "audiotools_tpu").rglob("*.py")
               if str(p.relative_to(ROOT / "audiotools_tpu")) not in NOT_PORTED)
HARNESS = PAIRS  # the name the first modules compared were listed under
# the port's modules without a twin in the JAX package: the kernels' build,
# wrappers and test shapes, the strict-fp32 context, the JAX-tree
# converter, the example apps (the JAX package's live in the repository's
# ``examples/``), and the tensor-parallel layers' collectives and placement
# (GSPMD does that for the JAX package)
PORT_MODULES = {"_build.py", "ops/hopper_kernels.py", "ops/ragged_shapes.py", "ops/_fp32.py",
                "models/convert.py", "examples/__init__.py", "examples/abx.py",
                "examples/codec.py", "examples/mushra.py", "examples/train_dac.py",
                "parallel/tensor.py"}


def test_every_module_without_a_jax_twin_is_listed():
    port = {str(p.relative_to(ROOT / "audiotools_tpu_torch"))
            for p in (ROOT / "audiotools_tpu_torch").rglob("*.py")}
    assert port - set(PAIRS) == PORT_MODULES


# flax modules define __call__ (and setup where they build submodules); the
# port's nn.Modules define __init__ and forward (the constructor arguments
# are the flax fields)
_DAC = ("DAC", "Encoder", "Decoder", "EncoderBlock", "DecoderBlock", "ResidualUnit", "Snake",
        "VectorQuantize", "ResidualVectorQuantize")
_DISC = ("Discriminator", "PeriodDiscriminator", "BandSpectrogramDiscriminator")


def _flax(classes, with_setup):
    return ({f"{c}.__call__" for c in classes} | {f"{c}.setup" for c in with_setup},
            {f"{c}.{m}" for c in classes for m in ("__init__", "forward")})


_FLAX_DAC = _flax(_DAC, ("DAC", "VectorQuantize", "ResidualVectorQuantize"))
_FLAX_DISC = _flax(_DISC, ("Discriminator",))

JAX_ONLY = {
    # imported and unused by the JAX package's module (an ``__init__``, so
    # its imports count as its names)
    "native/__init__.py": {"os"},
    # the pytree plumbing of a signal that JAX transformations carry
    "core/signal.py": {"AudioSignal.tree_flatten", "AudioSignal.tree_unflatten"},
    # the pytree mask sentinel of the transforms (a TPU workaround)
    "core/util.py": {"AlwaysTrue", "AlwaysTrue.__array__", "AlwaysTrue.__bool__",
                     "AlwaysTrue.__eq__", "AlwaysTrue.__hash__", "AlwaysTrue.__repr__",
                     "AlwaysTrue.__slots__"},
    # flax; SpectralGate.to is nn.Module's own
    "models/dac.py": _FLAX_DAC[0],
    "models/discriminators.py": _FLAX_DISC[0],
    "ml/layers/spectral_gate.py": {"SpectralGate.__call__", "SpectralGate.to"},
}
PORT_ONLY = {
    # the step folders' file names, and the complete steps on disk
    "ml/checkpoint.py": {"HOST_FILE", "STATE_FILE", "Checkpointer.steps"},
    # the libav probe compiles a test program in a temporary directory
    "native/__init__.py": {"tempfile"},
    # the card as the default device; numpy trees to tensors
    "core/util.py": {"as_device_tensor", "default_device", "from_numpy_tree"},
    # the kernels' wrappers and the JAX-tree converter
    "ops/__init__.py": {"hopper_kernels"},
    "models/__init__.py": {"convert"},
    # the meters' and filters' valid conv methods
    "ops/filters.py": {"CONV_METHODS"},
    "ops/loudness.py": {"CONV_METHODS"},
    # nn.Modules, the layers flax has built in, and the formulation names,
    # which the port all computes as convs (the JAX package's shifted-matmul
    # units, ``_ShiftedConv``, are not ported: slower on the card)
    "models/dac.py": _FLAX_DAC[1] | {"__all__", "Conv1d", "Conv1d.__init__", "Conv1d.forward",
                                   "ConvTranspose1dSame", "ConvTranspose1dSame.__init__",
                                   "ConvTranspose1dSame.forward", "conv_in_dtype",
                                   "lecun_normal_", "FORMULATIONS", "column_parallel"},
    "models/discriminators.py": _FLAX_DISC[1] | {"__all__", "WNConv2d", "WNConv2d.__init__",
                                              "WNConv2d.effective_weight", "WNConv2d.forward"},
    "ml/layers/base.py": {"__all__"},
    "models/adversarial.py": {"__all__"},
    "models/train.py": {"__all__"},
    # the halo transport, public beside the sharded ops
    "parallel/timeshard.py": {"ppermute"},
    # the decorator by which a kernel wrapper counts as its own work
    "ops/perf.py": {"counts_as"},
}
SIGNATURES = {
    # the mesh is a DeviceMesh over the process group; the device is the port's
    "Accelerator.__init__": (("self", "amp", "mesh", "data_axis"),
                             ("self", "amp", "mesh", "data_axis", "device")),
    # a module instead of a parameter tree, its rules over torch parameter names
    # and layouts; DistributedDataParallel's options
    "Accelerator.prepare_model": (("self", "params", "rules"),
                                  ("self", "model", "rules", "**kwargs")),
    # a module placed in place and returned, instead of a parameter tree
    "shard_params": (("params", "mesh", "tensor_axis"), ("model", "mesh", "tensor_axis")),
    # the same arguments; its rule reads torch layouts (a layer's output dim)
    "shard_params_rules": (("mesh", "tensor_axis"), ("mesh", "tensor_axis")),
    # the optimizer, stepped as torch's GradScaler steps it, instead of a callable
    "Accelerator.step": (("self", "optimizer_step", "*args", "**kwargs"), ("self", "optimizer")),
    # torch.profiler has no host tracer level
    "trace": (("log_dir", "host_tracer_level"), ("log_dir",)),
    # the native meter's device (the card unless told otherwise)
    "r128stats": (("filepath", "quiet"), ("filepath", "quiet", "device")),
    # a seeded generator instead of a JAX key
    "DSPMixin.corrupt_phase": (("self", "scale", "key"), ("self", "scale", "state")),
    # the equalizer's FIR route; the vocoder's options pass through
    "EffectMixin.equalizer": (("self", "db"), ("self", "db", "conv_method")),
    "EffectMixin.pitch_shift": (("self", "n_semitones", "quick"),
                                ("self", "n_semitones", "quick", "**kwargs")),
    "EffectMixin.time_stretch": (("self", "factor", "quick"),
                                 ("self", "factor", "quick", "**kwargs")),
    # where an array lands (the card by default)
    "ensure_tensor": (("x", "ndim", "batch_size"), ("x", "ndim", "batch_size", "device")),
    # the meter's options by name
    "loudness": (("audio_data", "sample_rate", "filter_class", "block_size", "**kwargs"),
                 ("audio_data", "sample_rate", "filter_class", "block_size", "use_fir", "zeros",
                  "conv_method")),
    # no parameter trees: a model holds its parameters
    "BaseModel.device": (("params",), ("self",)),
    "BaseModel.load": (("cls", "location", "package_name", "strict", "*args", "**kwargs"),
                       ("cls", "location", "package_name", "strict", "device", "*args",
                        "**kwargs")),
    "BaseModel.load_from_folder": (("cls", "folder", "package", "strict", "**kwargs"),
                                   ("cls", "folder", "package", "strict", "device", "**kwargs")),
    "BaseModel.save": (("self", "path", "params", "metadata", "package"),
                       ("self", "path", "metadata", "package")),
    "BaseModel.save_to_folder": (("self", "folder", "params", "extra_data", "package"),
                                 ("self", "folder", "extra_data", "package")),
    "compress": (("model", "params", "signal", "n_quantizers", "streaming", "chunk_frames"),
                 ("model", "signal", "n_quantizers", "streaming", "chunk_frames")),
    "decompress": (("model", "params", "artifact", "streaming", "chunk_frames"),
                   ("model", "artifact", "streaming", "chunk_frames")),
    "StreamingDecoder.__init__": (
        ("self", "model", "params", "batch_size", "chunk_frames", "halo_frames"),
        ("self", "model", "batch_size", "chunk_frames", "halo_frames")),
    "StreamingEncoder.__init__": (
        ("self", "model", "params", "batch_size", "chunk_frames", "halo_frames", "n_quantizers"),
        ("self", "model", "batch_size", "chunk_frames", "halo_frames", "n_quantizers")),
    "stream_decode": (("model", "params", "codes", "chunk_frames", "halo_frames"),
                      ("model", "codes", "chunk_frames", "halo_frames")),
    "stream_encode": (("model", "params", "audio", "chunk_frames", "halo_frames", "n_quantizers"),
                      ("model", "audio", "chunk_frames", "halo_frames", "n_quantizers")),
    "codec_loss": (("model", "params", "audio", "sample_rate", "return_recon"),
                   ("model", "audio", "sample_rate", "return_recon")),
    # a DeviceMesh of ranks on a device type instead of a mesh of devices
    "make_mesh": (("shape",), ("shape", "device")),
}


def _public(name):
    return all(not part.startswith("_") or part.startswith("__") for part in name.split("."))


def _params(fn):
    a = fn.args
    return (tuple(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)
            + ((f"*{a.vararg.arg}",) if a.vararg else ())
            + ((f"**{a.kwarg.arg}",) if a.kwarg else ()))


def _surface(path):
    """Public top-level names, class methods and class attributes, each with
    its parameter names (None for a value; an alias of a method has the
    method's); a class has the methods of its
    bases in the same module that it does not define itself. Imported names
    count where they are re-exported (a package's ``__init__``, or listed in
    ``__all__``)."""
    out, imported, exported, classes = {}, set(), set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            members = {}
            for base in node.bases:
                if isinstance(base, ast.Name):
                    members.update(classes.get(base.id, {}))
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    members[sub.name] = _params(sub)
                elif isinstance(sub, ast.Assign):
                    # an alias of a method has the method's parameters
                    value = (members.get(sub.value.id) if isinstance(sub.value, ast.Name)
                             else None)
                    members.update({t.id: value for t in sub.targets if isinstance(t, ast.Name)})
            classes[node.name] = members
            out[node.name] = None
            out.update({f"{node.name}.{k}": v for k, v in members.items()})
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
    """Every module pair has the same public names and signatures, but for
    the deliberate differences listed above."""
    jax_names = _surface(ROOT / "audiotools_tpu" / module)
    port_names = _surface(ROOT / "audiotools_tpu_torch" / module)
    assert set(jax_names) - set(port_names) == JAX_ONLY.get(module, set())
    assert set(port_names) - set(jax_names) == PORT_ONLY.get(module, set())
    for name in sorted(set(jax_names) & set(port_names)):
        if jax_names[name] != port_names[name]:
            assert SIGNATURES.get(name) == (jax_names[name], port_names[name]), name


@pytest.mark.parametrize("name", ["STFTParams", "metrics", "ml", "datasets", "transforms"])
def test_top_level_has_the_jax_packages_entry_points(name):
    """The names ``docs/tutorials/migrating.md`` gives as entry points."""
    import audiotools_tpu
    import audiotools_tpu_torch

    port = getattr(audiotools_tpu_torch, name)
    assert type(port) is type(getattr(audiotools_tpu, name))
    if name == "STFTParams":
        assert port is audiotools_tpu_torch.core.STFTParams
        assert port._fields == audiotools_tpu.STFTParams._fields
    else:
        assert port.__name__ == getattr(audiotools_tpu, name).__name__.replace(
            "audiotools_tpu", "audiotools_tpu_torch")


def _refusals(path):
    """Line numbers of ``raise NotImplementedError`` (bare or called)."""
    lines = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc.func if isinstance(node.exc, ast.Call) else node.exc
            if isinstance(exc, ast.Name) and exc.id == "NotImplementedError":
                lines.append(node.lineno)
    return lines


def test_no_module_refuses_work_the_jax_package_does(tmp_path):
    """The port does all that the JAX package does: no module of it raises
    ``NotImplementedError`` (a stub of a function not yet ported)."""
    found = {str(p.relative_to(ROOT)): _refusals(p)
             for p in sorted((ROOT / "audiotools_tpu_torch").rglob("*.py"))}
    assert len(found) == len(MODULES)
    assert {k: v for k, v in found.items() if v} == {}
    probe = tmp_path / "probe.py"
    probe.write_text("def f(x):\n    if x:\n        raise NotImplementedError('no')\n"
                     "    raise NotImplementedError\n    raise ValueError\n")
    assert sorted(_refusals(probe)) == [3, 4]
