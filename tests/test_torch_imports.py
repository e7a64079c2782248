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
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

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
    # the count of the bf16 synthesis's tensor-core products on the card
    "ops/fft.py": {"BF16_SYNTHESIS_GEMMS"},
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
    # the intervals of the spans made while torch.profiler recorded
    "_hostprof.py": {"ranges"},
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
    # a span's name may come in parts, joined only where a sink is on (a
    # transform's span takes its class name)
    "span": (("name",), ("name", "*parts")),
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


# -- every option value the JAX package takes --------------------------------


def _strings(node, constants):
    """The strings of a literal, a tuple, list or set of them, a sum of
    such tuples, or a module-level name bound to one."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return set().union(*(_strings(e, constants) for e in node.elts))
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _strings(node.left, constants) | _strings(node.right, constants)
    if isinstance(node, ast.Name):
        return set(constants.get(node.id, ()))
    return set()


def _only_raises(body):
    return (isinstance(body[-1], ast.Raise)
            and all(isinstance(s, (ast.Raise, ast.Expr, ast.Assign)) for s in body))


def _option_values(fn, constants):
    """``{(parameter, value): accepted}`` for every string that ``fn``
    compares one of its parameters with (``==``, ``!=``, ``in``, ``not
    in``). A value is refused where an ``==``/``in`` test of it guards a
    block that only raises."""
    params = {a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs}
    refusals = {id(node.test) for node in ast.walk(fn)
                if isinstance(node, ast.If) and _only_raises(node.body)}
    out = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.Eq, ast.NotEq, ast.In, ast.NotIn))):
            continue
        left, right = node.left, node.comparators[0]
        if isinstance(right, ast.Name) and right.id in params:
            left, right = right, left
        if not (isinstance(left, ast.Name) and left.id in params):
            continue
        refused = id(node) in refusals and isinstance(node.ops[0], (ast.Eq, ast.In))
        for value in _strings(right, constants):
            out[left.id, value] = out.get((left.id, value), True) and not refused
    return out


def _functions(path):
    """``({qualified function name: its node}, {module-level name: its
    strings})`` of a module, methods under ``Class.name``."""
    tree = ast.parse(path.read_text())
    constants = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            values = _strings(node.value, constants)
            constants.update({t.id: values for t in node.targets
                              if isinstance(t, ast.Name) and values})
    out = {}

    def visit(body, prefix):
        for node in body:
            if isinstance(node, ast.FunctionDef):
                out[prefix + node.name] = node
            elif isinstance(node, ast.ClassDef):
                visit(node.body, f"{prefix}{node.name}.")

    visit(tree.body, "")
    return out, constants


def _options(path):
    """``{qualified function name: _option_values}`` of a module."""
    functions, constants = _functions(path)
    return {name: _option_values(fn, constants) for name, fn in functions.items()}


def _option_gaps(jax_root, port_root, modules):
    """``(module, function, parameter, value)`` of each option value that a
    JAX function accepts and its twin in the port does not.

    It asks only whether the port takes each value that the JAX function
    names. What a value that the JAX function does not name does in either
    package is :func:`_unnamed_value_gaps`' question: an ``else`` in the port
    that computes where the JAX function's ``elif`` chain computes nothing
    takes every named value, so this scan passes it."""
    gaps = set()
    for module in modules:
        port_path = port_root / module
        port = _options(port_path) if port_path.exists() else {}
        for name, values in _options(jax_root / module).items():
            for (param, value), accepted in values.items():
                if accepted and not port.get(name, {}).get((param, value)):
                    gaps.add((module, name, param, value))
    return gaps


# option values the port takes by another route: each is a structural
# difference, with the reason (ROADMAP.md, "Deliberate differences")
OPTION_ROUTES = {
    # torch moves a signal to any device name; the JAX method took the two
    # strings only to leave its arrays where jax had placed them
    ("core/signal.py", "AudioSignal.to", "device", "cpu"): "torch's own device names",
    ("core/signal.py", "AudioSignal.to", "device", "cuda"): "torch's own device names",
    # the silent entry is read in AudioLoader.__call__ (no _read helper)
    ("data/datasets.py", "AudioLoader._read", "path", "none"): "read in __call__",
    # the per-item PESQ body is _pesq_parts, which takes the mode's tables
    ("ops/pesq.py", "_pesq_single", "mode", "wb"): "_pesq_parts' mode tables",
    # the per-shard bodies of the jitted sharded STFT and iSTFT: the port's
    # sharded_stft / sharded_istft compute them inline on the local shard,
    # the analysis through ops.fft._analysis, and check the method first
    ("parallel/timeshard.py", "_stft_raw", "method", "matmul"): "inline in sharded_stft",
    ("parallel/timeshard.py", "_stft_raw", "method", "matmul_bf16"): "inline in sharded_stft",
    ("parallel/timeshard.py", "_istft_raw", "method", "matmul"): "inline in sharded_istft",
    ("parallel/timeshard.py", "_istft_raw", "method", "matmul_bf16"): "inline in sharded_istft",
}


def test_the_port_takes_every_option_value_the_jax_package_does():
    """Every string a JAX function compares a parameter with (a method, a
    mode, a formulation name), the port's twin of that function accepts, or
    it is one of the structural routes above; a route that no longer
    differs is taken off the list."""
    gaps = _option_gaps(ROOT / "audiotools_tpu", ROOT / "audiotools_tpu_torch", PAIRS)
    assert gaps == set(OPTION_ROUTES)


def test_the_option_scan_finds_a_refused_value(tmp_path):
    """A probe pair: the JAX side takes four values of ``method``; its twin
    omits one, refuses another by name, and takes the rest through a
    module-level tuple and an ``else``."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax" / "m.py").write_text(
        "def f(x, method='a', mode='l'):\n"
        "    if method in ('a', 'b'):\n        return x\n"
        "    if method == 'c':\n        return -x\n"
        "    if 'd' == method:\n        return 2 * x\n"
        "    if mode == 'r':\n        raise ValueError(mode)\n"
        "    raise ValueError(method)\n"
        "class K:\n    def g(self, kind):\n        return kind != 'e'\n")
    (tmp_path / "port" / "m.py").write_text(
        "METHODS = ('a',) + ('b',)\n"
        "def f(x, method='a', mode='l'):\n"
        "    if method == 'c':\n        raise ValueError('not here')\n"
        "    if method not in METHODS:\n        raise ValueError(method)\n"
        "    return x\n"
        "class K:\n    def g(self, kind):\n        return kind != 'e'\n")
    assert _option_gaps(tmp_path / "jax", tmp_path / "port", ["m.py"]) == {
        ("m.py", "f", "method", "c"), ("m.py", "f", "method", "d")}


# -- what each package does with a value the JAX package never names ---------


_UNNAMED = "\x00"  # a string that no function names, starts or ends with


def _names(node, param):
    return any(isinstance(n, ast.Name) and n.id == param for n in ast.walk(node))


def _tests(node, param):
    """Whether a test of ``param`` lies anywhere inside ``node``."""
    return any(isinstance(n, (ast.If, ast.IfExp, ast.Assert, ast.While)) and _names(n.test, param)
               for n in ast.walk(node))


def _truth(test, param, value, constants):
    """Whether ``test`` holds with ``param`` bound to the string ``value``.
    It reads comparisons with strings (``==``, ``!=``, ``in``, ``not in``),
    ``is (not) None``, ``.startswith``/``.endswith`` of a literal, and
    ``and``, ``or``, ``not`` of them; None where the answer needs more."""
    if isinstance(test, ast.BoolOp):
        found = [_truth(v, param, value, constants) for v in test.values]
        stop = isinstance(test.op, ast.Or)
        return stop if stop in found else None if None in found else not stop
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        found = _truth(test.operand, param, value, constants)
        return None if found is None else not found
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        op, left, right = test.ops[0], test.left, test.comparators[0]
        if isinstance(op, (ast.Eq, ast.NotEq)) and isinstance(right, ast.Name) and right.id == param:
            left, right = right, left
        if not (isinstance(left, ast.Name) and left.id == param):
            return None
        if isinstance(op, (ast.Is, ast.IsNot)) and isinstance(right, ast.Constant):
            return (right.value is None) == isinstance(op, ast.IsNot)
        strings = _strings(right, constants)
        if strings and isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn)):
            return (value in strings) == isinstance(op, (ast.Eq, ast.In))
    if (isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute)
            and isinstance(test.func.value, ast.Name) and test.func.value.id == param
            and test.func.attr in ("startswith", "endswith") and len(test.args) == 1):
        strings = _strings(test.args[0], constants)
        return getattr(value, test.func.attr)(tuple(strings)) if strings else None
    return None


def _step(test, param, alive, constants):
    """The unnamed value's answer to ``test`` and the named values in
    ``alive`` that surely answer the same; None where it cannot be read."""
    taken = _truth(test, param, _UNNAMED, constants)
    if taken is None:
        return None, alive
    return taken, {v for v in alive if _truth(test, param, v, constants) == taken}


def _expression(node, param, alive, constants):
    """``alive`` after the conditional expressions on ``param`` in
    ``node``, each taking the unnamed value's branch; None where a test
    cannot be read."""
    if isinstance(node, ast.IfExp) and _names(node.test, param):
        taken, alive = _step(node.test, param, alive, constants)
        if taken is None:
            return None
        return _expression(node.body if taken else node.orelse, param, alive, constants)
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, (ast.Lambda, ast.FunctionDef)):
            alive = _expression(child, param, alive, constants)
            if alive is None:
                return None
    return alive


def _unnamed_outcomes(stmts, param, alive, constants):
    """Where a string that names none of ``alive`` goes through ``stmts``.

    ``alive`` holds the named values that have taken the same way so far.
    Code that tests nothing of ``param`` runs alike for every value and is
    passed over; a statement that holds such a test but does not test
    ``param`` itself (an ``if`` on another argument) is followed down each
    of its branches. The outcomes: ``"raise"`` where the value reaches a
    ``raise`` or fails an ``assert``; ``"else"`` where it runs code that a
    named value reaches the same way (an ``else``, a ``!=`` branch, or what
    follows a chain that a named value also passes through untested);
    ``"none"`` where no named value does (the code after an ``elif`` chain
    that every named value left by a branch of its own); ``"unread"`` at a
    test of ``param`` that :func:`_truth` cannot read."""
    for i, s in enumerate(stmts):
        rest = stmts[i + 1:]
        if isinstance(s, (ast.If, ast.Assert)) and _names(s.test, param):
            taken, alive = _step(s.test, param, alive, constants)
            if taken is None:
                return {"unread"}
            if isinstance(s, ast.Assert):
                if not taken:
                    return {"raise"}
                continue
            return _unnamed_outcomes((s.body if taken else s.orelse) + rest, param, alive,
                                     constants)
        if isinstance(s, ast.If) and _tests(s, param):
            return (_unnamed_outcomes(s.body + rest, param, alive, constants)
                    | _unnamed_outcomes(s.orelse + rest, param, alive, constants))
        if isinstance(s, (ast.With, ast.Try, ast.For, ast.While)) and _tests(s, param):
            return _unnamed_outcomes(s.body + rest, param, alive, constants)
        if isinstance(s, ast.Raise):
            return {"raise"}
        if not isinstance(s, (ast.FunctionDef, ast.ClassDef)):
            alive = _expression(s, param, alive, constants)
            if alive is None:
                return {"unread"}
        if isinstance(s, ast.Return):
            break
    return {"else" if alive else "none"}


def _unnamed_value_classes(jax_root, port_root, modules):
    """``{(module, function, parameter): (JAX class, port class)}`` for each
    parameter that a JAX function compares with strings: what a string
    outside those does in each package, the outcomes of
    :func:`_unnamed_outcomes` joined by ``|`` (``"absent"`` for a function
    the port does not have)."""
    out = {}
    for module in modules:
        port_path = port_root / module
        port, port_constants = _functions(port_path) if port_path.exists() else ({}, {})
        functions, constants = _functions(jax_root / module)
        for name, fn in functions.items():
            named = {}
            for param, value in _option_values(fn, constants):
                named.setdefault(param, set()).add(value)
            for param, values in named.items():
                out[module, name, param] = tuple(
                    "|".join(sorted(_unnamed_outcomes(f.body, param, values, c))) if f else "absent"
                    for f, c in ((fn, constants), (port.get(name), port_constants)))
    return out


def _unnamed_value_gaps(jax_root, port_root, modules):
    """The triples of :func:`_unnamed_value_classes` whose two classes
    differ.

    It compares where an unnamed value goes, read from the syntax of the two
    functions alone: a chain reached through a helper call in one package
    and inline in the other is a structural route (``OPTION_ROUTES``), and a
    test it cannot read makes a class ``unread``. What each package does
    with a value that it names is :func:`_option_gaps`' question."""
    return {key: classes for key, classes in
            _unnamed_value_classes(jax_root, port_root, modules).items()
            if classes[0] != classes[1]}


# the port refuses a value that the JAX function never names and computes as
# its default (``none``) or in an ``else`` branch; no documented value
# changes its result. Each entry is a port ``raise`` against a JAX ``none``
# or ``else`` (ROADMAP.md, "Deliberate differences")
UNNAMED_VALUE_REFUSALS = {
    # the meter's FIR route checks conv_method against CONV_METHODS first;
    # the JAX package's meter takes any other string to its FFT convolution
    ("ops/loudness.py", "apply_k_weighting", "conv_method"):
        "CONV_METHODS guard; JAX falls through to the FFT path",
    # the same guard on the equalizer's FIR; JAX runs its else (FFT) branch
    ("ops/filters.py", "equalizer", "conv_method"):
        "CONV_METHODS guard; JAX falls through to the FFT path",
}


def test_an_unnamed_option_value_goes_where_the_jax_package_sends_it():
    """A string that a JAX function never compares its parameter with
    raises, falls through, or takes an ``else`` in the port as it does in
    the JAX package. The listed refusals differ only by raising; a
    structural route of ``OPTION_ROUTES`` is exempt here for the same
    reason as there."""
    routed = {key[:3] for key in OPTION_ROUTES}
    gaps = {key: classes for key, classes in
            _unnamed_value_gaps(ROOT / "audiotools_tpu", ROOT / "audiotools_tpu_torch",
                                PAIRS).items() if key not in routed}
    assert set(gaps) == set(UNNAMED_VALUE_REFUSALS), gaps
    for key, (jax_class, port_class) in gaps.items():
        assert port_class == "raise" and "raise" not in jax_class.split("|"), key
        assert UNNAMED_VALUE_REFUSALS[key]


def test_the_unnamed_value_scan_finds_an_else_where_jax_has_an_elif(tmp_path):
    """A probe pair: the JAX side pads before or after through an ``elif``
    and no ``else``; its twin pads after in an ``else``, once as a
    conditional expression and once as a statement, refuses an unnamed
    method through a module-level tuple, and matches on the last function."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    chain = ("    if mode == 'before':\n        x = [0] + x\n"
             "    elif mode == 'after':\n        x = x + [0]\n    return x\n")
    (tmp_path / "jax" / "m.py").write_text(
        "def pad(x, mode='after'):\n" + chain
        + "def trim(x, mode='after'):\n" + chain
        + "def conv(x, method='fft'):\n"
        "    if method == 'direct':\n        return -x\n    return x\n"
        "def same(x, mode='after'):\n" + chain)
    (tmp_path / "port" / "m.py").write_text(
        "METHODS = ('fft',) + ('direct',)\n"
        "def pad(x, mode='after'):\n"
        "    return [0] + x if mode == 'before' else x + [0]\n"
        "def trim(x, mode='after'):\n"
        "    if mode == 'before':\n        x = [0] + x\n"
        "    else:\n        x = x + [0]\n    return x\n"
        "def conv(x, method='fft'):\n"
        "    if method not in METHODS:\n        raise ValueError(method)\n"
        "    return -x if method == 'direct' else x\n"
        "def same(x, mode='after'):\n" + chain)
    assert _unnamed_value_gaps(tmp_path / "jax", tmp_path / "port", ["m.py"]) == {
        ("m.py", "pad", "mode"): ("none", "else"),
        ("m.py", "trim", "mode"): ("none", "else"),
        ("m.py", "conv", "method"): ("none", "raise")}
    assert _unnamed_value_gaps(tmp_path / "jax", tmp_path / "jax", ["m.py"]) == {}
