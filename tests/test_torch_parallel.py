"""The port's sequence-parallel ops against the JAX package's.

Each world size (2 and 4) spawns that many ``gloo`` processes on the CPU
once (a module-scoped fixture); together they compute every sharded op and
every ``mesh=`` method of ``AudioSignal`` on seeded inputs, and rank 0 saves
the gathered results. Each case holds one result to the JAX package's
function on the same input, on a 2- or 4-device slice of the test session's
8 virtual devices, at the tolerance ``tests/parallel/test_timeshard.py`` or
``test_signal_api.py`` pins for it. The error cases and the mesh shapes come
from the same runs.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from jax.sharding import Mesh

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.ops.fft import istft as jistft
from audiotools_tpu.ops.fft import stft as jstft
from audiotools_tpu.parallel import (
    sharded_fir_conv as j_fir,
    sharded_frames as j_frames,
    sharded_istft as j_istft,
    sharded_loudness as j_loudness,
    sharded_resample as j_resample,
    sharded_stft as j_stft,
)
from audiotools_tpu.parallel import shard_signal as j_shard_signal

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 240  # seconds: a hung rank fails the test instead of the suite's clock
WORLDS = (2, 4)
SR = 44100
RATIOS = ((2, 3), (3, 2), (147, 160), (160, 147))
HOP_DIVS = (2, 4)


def _speechy(seed, t):
    rng = np.random.RandomState(seed)
    n = np.arange(t) / SR
    return (0.3 * np.sin(2 * np.pi * 220 * n) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * n))
            + 0.05 * rng.randn(t)).astype(np.float32)


def _inputs(n):
    """The seeded inputs of one world size (test_timeshard.py's and
    test_signal_api.py's, with shards of the same kind)."""
    rng = np.random.RandomState
    out = {
        "fir_x": rng(0).randn(2, 1, n * 2048).astype(np.float32),
        "fir_h": (rng(1).randn(501) * 0.05).astype(np.float32),
        "gain_x": rng(2).randn(1, 1, n * 64).astype(np.float32),
        "frames_x": rng(2).randn(2, n * 1024).astype(np.float32),
        "stft_x": rng(3).randn(2, n * 4 * 512).astype(np.float32),
        "rt_x": rng(4).randn(2, n * 4 * 512).astype(np.float32),
        "pad_x": rng(5).randn(1, n * 4 * 512).astype(np.float32),
        "sig_lufs": np.stack([_speechy(0, n * SR), _speechy(1, n * SR)])[:, None],
        "sig_stft": _speechy(2, n * 44032)[None, None],
        "sig_rs": _speechy(3, n * SR)[None, None],
    }
    for nch in (1, 2):
        x = rng(6).randn(2, nch, n * 17600).astype(np.float32) * 0.1
        x[:, :, x.shape[-1] // 3: x.shape[-1] // 2] *= 1e-4  # both gates engage
        out[f"lufs_{nch}"] = x
    T = n * 17600
    g = rng(7)
    out["lufs_rel"] = np.concatenate([g.randn(1, 1, T // 4).astype(np.float32) * 0.5,
                                      g.randn(1, 1, 3 * T // 4).astype(np.float32) * 0.003], -1)
    for old, new in RATIOS:
        out[f"rs_{old}_{new}"] = (rng(0).randn(2, n * old * 40) * 0.1).astype(np.float32)
    return out


WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
address, inp, out = sys.argv[3:6]
torch.set_num_threads(1)
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.ops.fft import istft, stft
from audiotools_tpu_torch.ops.filters import causal_fft_conv1d
from audiotools_tpu_torch.parallel import (make_mesh, shard_signal, sharded_fir_conv,
    sharded_frames, sharded_istft, sharded_loudness, sharded_resample, sharded_stft)
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

SR = 44100
meta = {}
try:
    make_mesh()
except RuntimeError as e:
    meta["no_group"] = str(e)
dist.init_process_group("gloo", init_method=address, rank=rank, world_size=world)
data = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
mesh = make_mesh({"sp": world}, device="cpu")
res = {}


def shard(x, dim=-1):
    n = x.shape[dim] // world
    return DTensor.from_local(x.narrow(dim, rank * n, n).contiguous(), mesh, [Shard(dim % x.ndim)])


def full(t):
    if t.is_complex():  # gathered as real pairs
        pairs = torch.view_as_real(t.to_local()).contiguous()
        return torch.view_as_complex(
            DTensor.from_local(pairs, mesh, t.placements).full_tensor()).numpy()
    return t.full_tensor().numpy()


def error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


res["fir"] = full(sharded_fir_conv(shard(data["fir_x"]), data["fir_h"], mesh))
res["gain"] = full(sharded_fir_conv(shard(data["gain_x"]), np.array([0.5], np.float32), mesh))
frames, meta["frames_n_valid"] = sharded_frames(shard(data["frames_x"]), 512, 128, mesh)
res["frames"] = full(frames)
for div, method in ((4, "fft"), (2, "matmul")):
    spec, meta[f"stft_{div}_n_valid"] = sharded_stft(shard(data["stft_x"]), 512, 512 // div,
                                                      mesh, method=method)
    res[f"stft_{div}"] = full(spec)
for div in (2, 4):
    hop, T = 512 // div, data["rt_x"].shape[-1]
    spec, n_valid = sharded_stft(shard(data["rt_x"]), 512, hop, mesh)
    res[f"rt_{div}"] = full(sharded_istft(spec, 512, hop, mesh, n_valid=n_valid))
    res[f"rt_{div}_matmul_bf16"] = full(
        sharded_istft(spec, 512, hop, mesh, method="matmul_bf16", n_valid=n_valid))
    res[f"rt_{div}_local_bf16"] = istft(torch.from_numpy(full(spec)[..., :n_valid]), 512, hop,
                                        length=T, method="matmul_bf16").numpy()
    spec, n_valid = sharded_stft(shard(data["rt_x"]), 512, hop, mesh, method="matmul")
    res[f"rt_{div}_matmul"] = full(
        sharded_istft(spec, 512, hop, mesh, method="matmul", n_valid=n_valid))
res["stft_bf16"] = full(sharded_stft(shard(data["stft_x"]), 512, 128, mesh,
                                     method="matmul_bf16")[0])
res["stft_bf16_local"] = stft(data["stft_x"], 512, 128, method="matmul_bf16").numpy()
pad = np.load(inp.replace("inputs", "pad_spec"))
res["pad"] = full(sharded_istft(shard(torch.from_numpy(pad["spec"])), 512, 128, mesh,
                                n_valid=int(pad["n_valid"])))
for key in ("lufs_1", "lufs_2", "lufs_rel"):
    res[key] = full(sharded_loudness(shard(data[key]), 16000, mesh))
for key in [k for k in data if k.startswith("rs_")]:
    _, old, new = key.split("_")
    res[key] = full(sharded_resample(shard(data[key]), int(old), int(new), mesh))

# the gradient crosses the halo exchange back: sharded == local autograd
x = data["fir_x"].clone().requires_grad_(True)
w = torch.from_numpy(np.random.RandomState(9).randn(*x.shape).astype(np.float32))
(sharded_fir_conv(shard(x), data["fir_h"], mesh).to_local() * shard(w).to_local()).sum().backward()
res["fir_grad"] = full(shard(x.grad))
x.grad = None
(causal_fft_conv1d(x, data["fir_h"]) * w).sum().backward()
res["fir_grad_local"] = x.grad.numpy()

# the AudioSignal surface
sig = AudioSignal(data["sig_lufs"], SR, device="cpu")
before = sig.loudness().clone()
shard_signal(sig, mesh)
meta["placed"] = [isinstance(sig.audio_data, DTensor), str(sig.audio_data.placements),
                  bool(torch.equal(sig._loudness, before))]
sig._loudness = None
res["sig_lufs"] = full(sig.loudness(mesh=mesh))
meta["sig_lufs_cached"] = sig._loudness is not None
sig = shard_signal(AudioSignal(data["sig_stft"], SR, device="cpu"), mesh)
res["sig_spec"] = full(sig.stft(2048, 512, "hann", match_stride=False, mesh=mesh))
meta["sig_n_valid"] = sig._stft_valid_frames
sig.istft(2048, 512, "hann", match_stride=False, length=data["sig_stft"].shape[-1], mesh=mesh)
res["sig_istft"] = full(sig.audio_data)
meta["sig_istft_placements"] = str(sig.audio_data.placements)
sig = shard_signal(AudioSignal(data["sig_rs"], SR, device="cpu"), mesh).resample(22050, mesh=mesh)
meta["sig_rs_rate"] = sig.sample_rate
res["sig_rs"] = full(sig.audio_data)

errors = {
    "signal_odd": lambda: shard_signal(AudioSignal(np.zeros((1, 1, world * 100 + 3), np.float32),
                                                   SR, device="cpu"), mesh),
    "fir_t": lambda: sharded_fir_conv(distribute_tensor(torch.zeros(1, 1, world * 64 + 1), mesh,
                                                        [Shard(2)]), np.zeros(3, np.float32), mesh),
    "fir_halo": lambda: sharded_fir_conv(shard(torch.zeros(1, 1, world * 64)),
                                         np.zeros(129, np.float32), mesh),
    "rs_phase": lambda: sharded_resample(shard(torch.zeros(1, world * 7)), 2, 3, mesh),
    "rs_halo": lambda: sharded_resample(shard(torch.zeros(1, world * 16)), 8000, 16000, mesh),
    "stft_odd": lambda: sharded_stft(shard(torch.zeros(1, world * 1152)), 257, 128, mesh),
    "match_stride": lambda: shard_signal(AudioSignal(data["sig_stft"], SR, device="cpu"),
                                         mesh).stft(2048, 512, "hann", match_stride=True,
                                                    mesh=mesh),
    "not_dtensor": lambda: sharded_fir_conv(data["fir_x"], data["fir_h"], mesh),
    "lufs_stride": lambda: sharded_loudness(shard(torch.zeros(1, 1, world * 17000)), 16000, mesh),
}
meta["errors"] = {k: error(fn) for k, fn in errors.items()}
meta["meshes"] = {
    "default": [make_mesh(device="cpu").mesh_dim_names, list(make_mesh(device="cpu").shape)],
    "fill": [make_mesh({"dp": 2, "sp": -1}, device="cpu").mesh_dim_names,
             list(make_mesh({"dp": 2, "sp": -1}, device="cpu").shape)],
}
meta["too_big"] = error(lambda: make_mesh({"sp": 2 * world}, device="cpu"))
if rank == 0:
    np.savez(out, **res)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def run(request, tmp_path_factory):
    """One spawn of ``n`` gloo ranks: ``(n, inputs, results, meta)``."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"parallel{n}")
    inputs = _inputs(n)
    np.savez(tmp / "inputs.npz", **inputs)
    # a single-device spectrogram zero-extended to the sharded frame grid
    spec = np.asarray(jstft(jnp.asarray(inputs["pad_x"]), 512, 128))
    nf_pad = n * (inputs["pad_x"].shape[-1] // n // 128 + 1)
    np.savez(tmp / "pad_spec.npz", n_valid=spec.shape[-1],
             spec=np.pad(spec, ((0, 0), (0, 0), (0, nf_pad - spec.shape[-1]))))
    address = f"tcp://localhost:{_free_port()}"
    out = str(tmp / "out.npz")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(n), address,
                               str(tmp / "inputs.npz"), out], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        outputs = [p.communicate(timeout=JOIN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outputs):
        assert p.returncode == 0, err[-3000:]
    with open(out + ".json") as f:
        meta = json.load(f)
    return n, inputs, dict(np.load(out)), meta


def _max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_fir_conv_matches_jax(run):
    n, x, got, _ = run
    want = j_fir(jnp.asarray(x["fir_x"]), jnp.asarray(x["fir_h"]), _jmesh(n))
    assert got["fir"].shape == want.shape
    assert _max(got["fir"], want) < 1e-4


def test_fir_conv_length_one_kernel_is_a_gain(run):
    n, x, got, _ = run
    want = np.asarray(j_fir(jnp.asarray(x["gain_x"]), jnp.asarray([0.5], jnp.float32), _jmesh(n)))
    assert got["gain"].shape == x["gain_x"].shape
    assert np.array_equal(got["gain"], want)


def test_fir_conv_gradient_crosses_the_halo(run):
    _, _, got, _ = run
    assert _max(got["fir_grad"], got["fir_grad_local"]) < 1e-4


def test_frames_match_jax(run):
    n, x, got, meta = run
    want, n_valid = j_frames(jnp.asarray(x["frames_x"]), 512, 128, _jmesh(n))
    assert meta["frames_n_valid"] == n_valid
    assert got["frames"].shape == want.shape
    assert _max(got["frames"], want) < 1e-5
    assert np.abs(got["frames"][:, n_valid:]).max() == 0


@pytest.mark.parametrize("hop_div,method", [(4, "fft"), (2, "matmul")])
def test_stft_matches_jax(run, hop_div, method):
    n, x, got, meta = run
    want, n_valid = j_stft(jnp.asarray(x["stft_x"]), 512, 512 // hop_div, _jmesh(n),
                           method=method)
    want = np.asarray(want)
    assert meta[f"stft_{hop_div}_n_valid"] == n_valid
    spec = got[f"stft_{hop_div}"]
    assert spec.shape == want.shape
    assert _max(spec, want) / np.abs(want).max() < 1e-5
    assert np.abs(spec[..., n_valid:]).max() == 0


@pytest.mark.parametrize("hop_div", HOP_DIVS)
def test_istft_round_trip_matches_jax(run, hop_div):
    n, x, got, _ = run
    mesh, hop = _jmesh(n), 512 // hop_div
    spec, n_valid = j_stft(jnp.asarray(x["rt_x"]), 512, hop, mesh)
    want = np.asarray(j_istft(spec, 512, hop, mesh, n_valid=n_valid))
    y = got[f"rt_{hop_div}"]
    assert y.shape == x["rt_x"].shape
    assert _max(y, want) < 1e-5
    assert _max(y, x["rt_x"]) < 1e-4


@pytest.mark.parametrize("hop_div", HOP_DIVS)
def test_istft_matmul_round_trip_matches_jax(run, hop_div):
    n, x, got, _ = run
    mesh, hop = _jmesh(n), 512 // hop_div
    spec, n_valid = j_stft(jnp.asarray(x["rt_x"]), 512, hop, mesh, method="matmul")
    want = np.asarray(j_istft(spec, 512, hop, mesh, method="matmul", n_valid=n_valid))
    y = got[f"rt_{hop_div}_matmul"]
    assert y.shape == x["rt_x"].shape
    assert _max(y, want) < 1e-5
    assert _max(y, x["rt_x"]) < 1e-4


@pytest.mark.parametrize("hop_div", HOP_DIVS)
def test_istft_bf16_synthesis_equals_the_local_one(run, hop_div):
    """On the CPU the JAX package's bf16 products sum in fp32, so it is no
    reference for the bf16 synthesis: the sharded one equals the port's
    single-device ``istft(method="matmul_bf16")`` of the same spectrum."""
    _, x, got, _ = run
    y = got[f"rt_{hop_div}_matmul_bf16"]
    assert y.shape == x["rt_x"].shape
    assert _max(y, got[f"rt_{hop_div}_local_bf16"]) < 1e-5


def test_stft_bf16_analysis_rounds_its_operands(run):
    """The bf16 analysis rounds frames and DFT matrices to bf16 (unit
    roundoff 2^-8 each) and sums in fp32: off the fp32 spectrum by more
    than fp32 rounding, and, as the products' rounding errors partly
    cancel in each sum, by less than 2^-8 of its scale."""
    _, _, got, _ = run
    err = _max(got["stft_bf16"], got["stft_4"]) / np.abs(got["stft_4"]).max()
    assert 1e-6 < err < 2.0 ** -8


def test_stft_bf16_analysis_is_the_single_device_one(run):
    """The sharded bf16 analysis and the port's single-device
    ``stft(method="matmul_bf16")`` round the same frames and matrices
    through one helper (``ops.fft._analysis``) and sum them in fp32: within
    1e-6 of the spectrum's scale on the valid frames, across the halos of 2
    and 4 shards (one shard would refuse this 512/128 geometry)."""
    _, _, got, meta = run
    n_valid = meta["stft_4_n_valid"]
    want = got["stft_bf16_local"]
    assert want.shape[-1] == n_valid
    assert _max(got["stft_bf16"][..., :n_valid], want) / np.abs(want).max() < 1e-6


def test_istft_consumes_single_device_stft(run):
    n, x, got, _ = run
    want = np.asarray(jistft(jstft(jnp.asarray(x["pad_x"]), 512, 128), 512, 128,
                             length=x["pad_x"].shape[-1]))
    assert _max(got["pad"], want) < 1e-5


@pytest.mark.parametrize("key", ["lufs_1", "lufs_2", "lufs_rel"])
def test_loudness_matches_jax(run, key):
    n, x, got, _ = run
    want = np.asarray(j_loudness(jnp.asarray(x[key]), 16000, _jmesh(n)))
    assert got[key].shape == want.shape
    assert _max(got[key], want) < 1e-5


@pytest.mark.parametrize("old_new", RATIOS, ids=lambda r: f"{r[0]}to{r[1]}")
def test_resample_matches_jax(run, old_new):
    n, x, got, _ = run
    old, new = old_new
    want = np.asarray(j_resample(jnp.asarray(x[f"rs_{old}_{new}"]), old, new, _jmesh(n)))
    assert got[f"rs_{old}_{new}"].shape == want.shape
    assert _max(got[f"rs_{old}_{new}"], want) < 1e-6


def test_shard_signal_places_the_time_axis(run):
    n, _, _, meta = run
    is_dtensor, placements, cache_kept = meta["placed"]
    assert is_dtensor and placements == "(Shard(dim=2),)" and cache_kept
    assert meta["errors"]["signal_odd"].startswith("ValueError") and \
        "divide" in meta["errors"]["signal_odd"]


def test_loudness_mesh_matches_jax(run):
    n, x, got, meta = run
    mesh = _jmesh(n)
    want = np.asarray(j_shard_signal(JSignal(x["sig_lufs"], SR), mesh).loudness(mesh=mesh))
    assert got["sig_lufs"].shape == want.shape
    assert _max(got["sig_lufs"], want) < 1e-3
    assert meta["sig_lufs_cached"]


def test_stft_istft_mesh_round_trip_matches_jax(run):
    n, x, got, meta = run
    mesh, t = _jmesh(n), x["sig_stft"].shape[-1]
    sig = j_shard_signal(JSignal(x["sig_stft"], SR), mesh)
    spec = np.asarray(sig.stft(2048, 512, "hann", match_stride=False, mesh=mesh))
    assert meta["sig_n_valid"] == sig._stft_valid_frames
    valid = slice(0, meta["sig_n_valid"])
    assert np.abs(np.abs(got["sig_spec"][..., valid]) - np.abs(spec[..., valid])).max() < 1e-3
    sig.istft(2048, 512, "hann", match_stride=False, length=t, mesh=mesh)
    assert _max(got["sig_istft"], sig.audio_data) < 1e-4
    assert _max(got["sig_istft"], x["sig_stft"]) < 1e-4
    assert meta["sig_istft_placements"] == "(Shard(dim=2),)"


def test_resample_mesh_matches_jax(run):
    n, x, got, meta = run
    mesh = _jmesh(n)
    want = j_shard_signal(JSignal(x["sig_rs"], SR), mesh).resample(22050, mesh=mesh)
    assert meta["sig_rs_rate"] == 22050
    assert got["sig_rs"].shape == want.audio_data.shape
    assert _max(got["sig_rs"], want.audio_data) < 1e-4


@pytest.mark.parametrize("case,kind,match", [
    ("fir_t", "ValueError", "must divide"),
    ("fir_halo", "ValueError", "fit in one shard"),
    ("rs_phase", "ValueError", "polyphase phase"),
    ("rs_halo", "ValueError", "fit in one shard"),
    ("stft_odd", "ValueError", "even"),
    ("match_stride", "ValueError", "match_stride"),
    ("not_dtensor", "TypeError", "DTensor"),
    ("lufs_stride", "ValueError", "strides"),
])
def test_contract_violations_raise(run, case, kind, match):
    """The JAX package's checks, kept: each raises before any exchange."""
    _, _, _, meta = run
    err = meta["errors"][case]
    assert err is not None and err.startswith(kind) and match in err, err


@pytest.mark.parametrize("T,n,win,hop", [
    (4096, 1, 2048, 512),  # one shard: n_dev * hop < window / 2
    (4096, 1, 2048, 1024),
    (8192, 4, 2048, 512),
    (8192, 8, 2048, 512),  # too wide for the shard length
    (4096, 2, 512, 96),  # window / 2 not a hop multiple
    (4097, 2, 512, 128),
])
def test_stft_geometry_accepts_what_jax_accepts(T, n, win, hop):
    """The shard geometry of the sharded STFT and iSTFT: the port refuses
    (ValueError) exactly the configurations the JAX package asserts against,
    and agrees on the rest."""
    from audiotools_tpu.parallel.timeshard import _stft_geometry as j_geometry

    from audiotools_tpu_torch.parallel.timeshard import _stft_geometry

    try:
        want = j_geometry(T, n, win, hop)
    except AssertionError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0]):
            _stft_geometry(T, n, win, hop)
    else:
        assert _stft_geometry(T, n, win, hop) == want


def test_make_mesh_shapes(run):
    n, _, _, meta = run
    assert meta["meshes"]["default"] == [["dp"], [n]]
    assert meta["meshes"]["fill"] == [["dp", "sp"], [2, n // 2]]
    assert "needs" in meta["too_big"]
    assert "init_process_group" in meta["no_group"]
