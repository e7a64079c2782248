"""The augmentation path end to end: the port against the JAX package on
the CPU.

(a) The port's dataset and transforms draw the same parameters and load
    the same audio as the JAX package's.
(b) The JAX package's batch, fed into the port (``util.from_numpy_tree``),
    comes out of Compose -> pitch shift -> mel -> LUFS as it does from the
    JAX chain.
(b') The same for the reference-parity configuration: the FIR meter of
     ``set_fast_meter(True)`` (kernel C's route) and the fused bf16
     synthesis (kernel E's route).
(c) The port reproduces every committed regression WAV, one for each of
    the 25 leaf transforms (it never writes them).
"""
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.core import util as ju
from audiotools_tpu.data import transforms as jt
from audiotools_tpu.data.datasets import AudioDataset as JDataset
from audiotools_tpu.data.datasets import AudioLoader as JLoader
from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.data import DataLoader
from audiotools_tpu_torch.data import transforms as pt
from audiotools_tpu_torch.data.datasets import AudioDataset as PDataset
from audiotools_tpu_torch.data.datasets import AudioLoader as PLoader
from audiotools_tpu_torch.io import read_wav
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import stretch as PS
from tests.fixtures import speech_like

SR = 44100
REGRESSION_DIR = Path(__file__).parent / "regression" / "transforms"
# the leaf transforms, discovered as tests/data/test_regression.py discovers them
FRAMEWORK = {"BaseTransform", "SpectralTransform", "Compose", "Choose", "Repeat", "RepeatUpTo",
             "Identity"}
LEAVES = sorted(x for x in dir(jt) if isinstance(getattr(jt, x), type)
                and issubclass(getattr(jt, x), jt.BaseTransform) and x not in FRAMEWORK)


def _dataset(tfm, Dataset, Loader, root, n, duration=1.0):
    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")]),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    return Dataset(Loader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                   n_examples=n, duration=duration, transform=transform)


@pytest.fixture(scope="module")
def batches(audio_dir):
    """The same 2-item batch collated by each package (leaves as numpy for
    the JAX one)."""
    jds = _dataset(jt, JDataset, JLoader, audio_dir, 2)
    pds = _dataset(pt, PDataset, PLoader, audio_dir, 2)
    jbatch = ju.collate([jds[i] for i in range(2)])
    return jds, jbatch, pds, pu.collate([pds[i] for i in range(2)])


def test_same_draws(batches):
    _, jbatch, _, pbatch = batches
    jnp_batch = jax.tree_util.tree_map(np.asarray, jbatch)
    assert np.abs(np.asarray(jnp_batch["signal"].audio_data)
                  - pbatch["signal"].audio_data.numpy()).max() < 1e-6
    assert list(pbatch["idx"]) == list(jnp_batch["idx"])
    jargs, pargs = jnp_batch["transform_args"]["Compose"], pbatch["transform_args"]["Compose"]
    assert sorted(jargs) == sorted(pargs)
    assert np.all(pargs["mask"]) and np.all(np.asarray(jargs["mask"]))  # Compose's own
    for name in (n for n in jargs if n != "mask"):
        assert sorted(jargs[name]) == sorted(pargs[name]), name
        for key, want in jargs[name].items():
            got = pargs[name][key]
            if key == "mask":
                assert np.all(np.asarray(want)) and got.dtype == bool and np.all(got)
            elif hasattr(want, "audio_data"):
                assert np.abs(np.asarray(want.audio_data) - got.audio_data.numpy()).max() < 1e-6
            else:  # eq, snr, drr, db: drawn from the same RandomState, exactly
                assert np.array_equal(np.asarray(want), np.asarray(got)), (name, key)


def _jax_chain(ds, batch, synthesis_method="matmul"):
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    audio = JS.pitch_shift(out.audio_data, 2.0, SR, synthesis_method=synthesis_method,
                           pv_formulation="phasor_fused_interpret")
    return (np.asarray(audio), np.asarray(JF.mel_spectrogram(audio, SR, 80, method="matmul")),
            np.asarray(JL.loudness(audio, SR)))


def _port_chain(ds, batch, synthesis_method="matmul"):
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    audio = PS.pitch_shift(out.audio_data, 2.0, SR, synthesis_method=synthesis_method,
                           pv_formulation="phasor_fused")
    return (audio.numpy(), PF.mel_spectrogram(audio, SR, 80, method="matmul").numpy(),
            PL.loudness(audio, SR).numpy())


def test_same_output(batches):
    jds, jbatch, pds, pbatch = batches
    want = _jax_chain(jds, jbatch)
    fed = pu.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jbatch), "cpu")
    audio, mel, lufs = _port_chain(pds, fed)
    assert audio.shape == want[0].shape == (2, 1, SR)
    assert np.abs(audio - want[0]).max() < 1e-4
    assert np.abs(mel - want[1]).max() / np.abs(want[1]).max() < 1e-4
    assert np.abs(lufs - want[2]).max() < 0.01
    # the port's own batch is the same batch
    own = _port_chain(pds, pu.prepare_batch(pbatch, "cpu"))
    for a, b in zip(own, (audio, mel, lufs)):
        assert np.array_equal(a, b)


def test_same_output_reference_parity(batches):
    """Both packages with ``set_fast_meter(True)`` (every meter call of the
    chain, the transforms' included, on the 1023-tap FIR) and the fused bf16
    synthesis; the meters are restored whatever happens."""
    jds, jbatch, pds, _ = batches
    fed = pu.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jbatch), "cpu")
    try:
        JL.set_fast_meter(True)
        PL.set_fast_meter(True)
        want = _jax_chain(jds, jbatch, "matmul_bf16_fused_interpret")
        audio, mel, lufs = _port_chain(pds, fed, "matmul_bf16_fused")
    finally:
        JL.set_fast_meter(False)
        PL.set_fast_meter(False)
    assert audio.shape == want[0].shape == (2, 1, SR)
    assert np.abs(audio - want[0]).max() < 1e-4
    # a spectrum value within fp32 rounding of a bf16 rounding boundary goes
    # to different bf16 neighbours in the two packages, one bf16 ulp (2**-8)
    # of itself apart; the mel frames sum many such samples (1.7e-4 here,
    # against 1e-4 for the fp32 synthesis above)
    assert np.abs(mel - want[1]).max() / np.abs(want[1]).max() < 1e-3
    assert np.abs(lufs - want[2]).max() < 0.01
    # the configuration does change the output: the FIR meter's gains and
    # the bf16 synthesis against the exact meter and the fp32 synthesis
    assert np.abs(audio - _port_chain(pds, fed)[0]).max() > 1e-4


@pytest.mark.parametrize("name", LEAVES)
def test_regression_wavs(name, audio_dir):
    """The setup of tests/data/test_regression.py, through the port."""
    sources = {"BackgroundNoise": "nz.csv", "CrossTalk": "spk.csv",
               "RoomImpulseResponse": "ir.csv"}
    cls = getattr(pt, name)
    transform = cls(sources=[str(audio_dir / sources[name])]) if name in sources else cls()
    signal = AudioSignal(speech_like(3, 1.0)[None, None], SR, device="cpu")
    signal.metadata["loudness"] = float(signal.loudness()[0])
    kwargs = transform.instantiate(0, signal)
    output = transform(signal.clone(), **kwargs)
    golden, sr = read_wav(REGRESSION_DIR / f"{name}.wav")
    assert sr == SR
    assert np.allclose(output.audio_data[0].numpy(), golden, atol=1e-4)


def test_from_numpy_tree_keeps_masks_on_the_host(batches):
    _, jbatch, _, _ = batches
    fed = pu.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jbatch), "cpu")
    args = fed["transform_args"]["Compose"]
    assert isinstance(args["0.RoomImpulseResponse"]["mask"], np.ndarray)
    assert isinstance(args["0.RoomImpulseResponse"]["drr"], torch.Tensor)
    assert isinstance(args["1.BackgroundNoise"]["bg_signal"], AudioSignal)
    assert isinstance(fed["signal"].audio_data, torch.Tensor)
    assert fed["path"] == list(jbatch["path"])


def test_masked_transform_selects_per_item(batches):
    """A mask with a False item takes the compute-all-then-select path."""
    _, _, pds, pbatch = batches
    sig = pbatch["signal"]
    eq = pt.Equalizer(name="eq")
    kwargs = {"eq": {"eq": pbatch["transform_args"]["Compose"]["2.Equalizer"]["eq"],
                     "mask": np.array([True, False])}}
    out = eq(sig.clone(), **kwargs)
    full = eq(sig.clone(), **{"eq": dict(kwargs["eq"], mask=np.array([True, True]))})
    assert torch.equal(out.audio_data[0], full.audio_data[0])
    assert torch.equal(out.audio_data[1], sig.audio_data[1])
    assert out[np.array([False, True])].batch_size == 1


def test_loader_stages_the_same_batch(batches):
    _, _, pds, pbatch = batches
    loaded = list(DataLoader(pds, batch_size=2, num_workers=2, device="cpu"))
    assert len(loaded) == 1
    got = loaded[0]
    assert torch.equal(got["signal"].audio_data, pbatch["signal"].audio_data)
    eq = got["transform_args"]["Compose"]["2.Equalizer"]["eq"]
    assert isinstance(eq, torch.Tensor)
    assert np.array_equal(eq.numpy(), pbatch["transform_args"]["Compose"]["2.Equalizer"]["eq"])
    assert isinstance(got["transform_args"]["Compose"]["2.Equalizer"]["mask"], np.ndarray)
    sync = list(DataLoader(pds, batch_size=1, num_workers=0, device="cpu"))
    assert [int(b["idx"][0]) for b in sync] == [0, 1]


def _producers():
    return [t for t in threading.enumerate() if t.name == "DataLoader-producer"]


def test_loader_stops_its_thread_after_an_early_break(batches):
    _, _, pds, _ = batches
    for _ in DataLoader(pds, batch_size=1, num_workers=2, prefetch_batches=1, device="cpu"):
        break
    deadline = time.monotonic() + 30
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _producers()


def test_loader_raises_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, idx):
            raise OSError(f"cannot read item {idx}")

    with pytest.raises(OSError, match="cannot read item"):
        list(DataLoader(Broken(), batch_size=2, num_workers=2, device="cpu"))
    assert not _producers()


def test_salient_excerpt_retries_like_jax(audio_dir):
    """An unreachable cutoff exercises the batched retry: same offsets."""
    from audiotools_tpu import AudioSignal as JAudioSignal

    path = str(audio_dir / "spk" / "spk_0.wav")
    want = JAudioSignal.salient_excerpt(path, loudness_cutoff=0.0, num_tries=4,
                                        state=3, duration=0.5)
    got = AudioSignal.salient_excerpt(path, loudness_cutoff=0.0, num_tries=4,
                                      state=3, duration=0.5, device="cpu")
    assert got.metadata["offset"] == want.metadata["offset"]
    assert np.array_equal(got.audio_data.numpy(), np.asarray(want.audio_data))
    assert abs(float(got._loudness) - float(np.asarray(want._loudness))) < 5e-3
