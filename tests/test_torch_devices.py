"""Where the port's signals and loaders put their data.

The port computes on the card by default, as the JAX package computes on
its accelerator: a signal built from a path, a numpy array or a list, and
every batch of the DataLoader, go to ``cuda`` unless ``device="cpu"`` is
given, and without a card such a construction raises. A tensor stays on
its own device. The AudioLoader decodes and meters on the host.

Each test decides in its own body whether a card is present: with
``torch.cuda.is_available`` patched to False the "no card" paths run on
any machine, and patched to True the default resolves to ``cuda`` without
touching a card.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core import util
from audiotools_tpu_torch.data import DataLoader
from audiotools_tpu_torch.data.datasets import AudioLoader
from audiotools_tpu_torch.io import write_wav

SR = 16000


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def card(monkeypatch):
    """A card is reported present; nothing in these tests may allocate on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def _audio(n=SR // 2):
    return (np.random.RandomState(0).randn(1, 1, n) * 0.1).astype(np.float32)


def test_the_default_device_is_the_card(card):
    assert util.default_device() == torch.device("cuda")
    assert DataLoader([], batch_size=1).device == torch.device("cuda")
    assert DataLoader([], batch_size=1, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("source", ["array", "list", "path", "zeros"])
def test_construction_without_a_card_raises(no_card, tmp_path, source):
    x = _audio()
    path = tmp_path / "a.wav"
    write_wav(path, x[0], SR)
    build = {
        "array": lambda **kw: AudioSignal(x, SR, **kw),
        "list": lambda **kw: AudioSignal(list(x[0, 0]), SR, **kw),
        "path": lambda **kw: AudioSignal(path, **kw),
        "zeros": lambda **kw: AudioSignal.zeros(0.1, SR, **kw),
    }[source]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert build(device="cpu").device.type == "cpu"


def test_loader_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader([], batch_size=1)


def test_a_tensor_keeps_its_device(no_card):
    sig = AudioSignal(torch.from_numpy(_audio()), SR)
    assert sig.device.type == "cpu"
    meta = AudioSignal(torch.zeros(1, 1, 100, device="meta"), SR)
    assert meta.device.type == "meta"


def test_signals_built_from_signals_keep_their_device(card):
    """clone, batch and indexing build from tensors: with a card present
    they still stay where their source is."""
    sig = AudioSignal(_audio(), SR, device="cpu")
    assert sig.clone().device.type == "cpu"
    assert AudioSignal.batch([sig.clone(), sig.clone()]).device.type == "cpu"
    assert AudioSignal.batch([sig.clone(), sig.clone()])[0].device.type == "cpu"


def test_audio_loader_decodes_and_meters_on_the_host(card, tmp_path):
    write_wav(tmp_path / "a.wav", _audio(SR)[0], SR)
    loader = AudioLoader(sources=[str(tmp_path)])
    item = loader(util.random_state(0), sample_rate=SR, duration=0.25)
    assert item["signal"].device.type == "cpu"
    assert item["signal"].signal_length == SR // 4
    item = loader(util.random_state(0), sample_rate=SR, duration=0.25, offset=0.1)
    assert item["signal"].device.type == "cpu"


def test_salient_excerpt_meters_on_the_host_and_returns_on_the_default_device(
        card, monkeypatch, tmp_path):
    """Every draw is decoded and metered on the host; only the chosen
    excerpt goes to the default device (here ``meta``, which holds no data,
    so metering it would fail)."""
    write_wav(tmp_path / "a.wav", _audio(SR)[0], SR)
    kw = dict(loudness_cutoff=0.0, num_tries=3, state=4, duration=0.25)
    want = AudioSignal.salient_excerpt(tmp_path / "a.wav", device="cpu", **kw)
    monkeypatch.setattr(util, "default_device", lambda: torch.device("meta"))
    got = AudioSignal.salient_excerpt(tmp_path / "a.wav", **kw)
    assert got.device.type == "meta" and got._loudness.device.type == "meta"
    assert got.metadata["offset"] == want.metadata["offset"]
    assert got.audio_data.shape == want.audio_data.shape


def test_salient_excerpt_without_a_card_raises(no_card, tmp_path):
    write_wav(tmp_path / "a.wav", _audio(SR)[0], SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioSignal.salient_excerpt(tmp_path / "a.wav", loudness_cutoff=-70.0, duration=0.25)


def test_from_numpy_tree_builds_signals_on_the_host(card):
    class Signal:
        audio_data = _audio(100)
        sample_rate = SR

    fed = util.from_numpy_tree({"signal": Signal(), "x": np.ones(2, np.float32)}, "cpu")
    assert fed["signal"].device.type == "cpu"
    assert fed["x"].device.type == "cpu"
