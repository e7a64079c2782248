"""The port's data pipeline against the JAX package's on the CPU: the chord
fixture, aligned multitrack datasets, ``ConcatDataset``, the resumable
samplers and the loader's ``sampler``, ``drop_last``, ``collate_fn`` and
int16 wire.

Draws come from the same seeds in both packages, so paths, offsets, source
and item indices, sampler sequences and decoded audio are compared for
equality; CSV loudness at the meters' parity pin, 5e-3 dB
(tests/test_torch_ops.py).
"""
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from audiotools_tpu.core import util as ju
from audiotools_tpu.data import datasets as jd
from audiotools_tpu.data import transforms as jt
from audiotools_tpu.data.loader import DataLoader as JDataLoader
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.data import DataLoader
from audiotools_tpu_torch.data import datasets as pd
from audiotools_tpu_torch.data import preprocess
from audiotools_tpu_torch.data import transforms as pt

SR = 44100
WIRE_ERR = 2.0 ** -16 * (1 + 1e-6)  # int16 rounding: half a level of 2**-15


def _audio(sig):
    a = sig.audio_data
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def chords(tmp_path_factory):
    """The chord fixture written by each package from the same seed."""
    root = tmp_path_factory.mktemp("chords")
    kw = dict(max_voices=3, num_items=4, duration=0.5)
    ju.seed(3)
    jax_root = ju.generate_chord_dataset(output_dir=root / "jax", **kw)
    pu.seed(3)
    port_root = pu.generate_chord_dataset(output_dir=root / "port", **kw)
    return jax_root, port_root


def test_chord_dataset_matches_jax(chords):
    jax_root, port_root = chords
    files = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*.wav"))
    assert files == sorted(p.relative_to(port_root) for p in port_root.rglob("*.wav"))
    assert len(files) > 4  # some tracks have more than one voice
    for f in files:
        assert (jax_root / f).read_bytes() == (port_root / f).read_bytes()
    csvs = sorted(p.name for p in jax_root.glob("*.csv"))
    assert csvs == sorted(p.name for p in port_root.glob("*.csv"))
    for name in csvs:
        want, got = _rows(jax_root / name), _rows(port_root / name)
        assert [Path(r["path"]).relative_to(jax_root) if r["path"] else "" for r in want] == [
            Path(r["path"]).relative_to(port_root) if r["path"] else "" for r in got]
        for w, g in zip(want, got):
            if w["path"]:
                assert abs(float(w["loudness"]) - float(g["loudness"])) < 5e-3
            else:
                assert float(g["loudness"]) == -np.inf


def test_create_csv_paths_relative_to_the_data(tmp_path, chords):
    _, root = chords
    files = sorted(root.rglob("*.wav"))[:2]
    out = preprocess.create_csv([str(f) for f in files] + [""], tmp_path / "a.csv",
                                data_path=root)
    rows = _rows(out)
    assert [r["path"] for r in rows] == [str(f.relative_to(root)) for f in files] + [""]
    assert set(rows[0]) == {"path"}


def _datasets(root, **kw):
    voices = sorted(root.glob("voice_*.csv"))
    build = []
    for mod in (jd, pd):
        loaders = {p.stem: mod.AudioLoader(sources=[str(p)]) for p in voices}
        build.append(mod.AudioDataset(loaders, sample_rate=SR, n_examples=6, duration=0.25,
                                      aligned=True, **kw))
    return build


def _same_items(jitem, pitem, names):
    for name in names:
        j, p = jitem[name], pitem[name]
        for key in ("path", "source_idx", "item_idx", "source"):
            assert p[key] == j[key], (name, key)
        assert p["signal"].metadata["offset"] == j["signal"].metadata["offset"]
        np.testing.assert_array_equal(_audio(p["signal"]), _audio(j["signal"]))


@pytest.mark.parametrize("kw", [{}, {"shuffle_loaders": True}, {"without_replacement": False}])
def test_aligned_draws_match_jax(chords, kw):
    """Same files, offsets, source and item indices and audio; the followers
    read the leader's file and offset (silence where a track lacks the
    voice)."""
    jds, pds = _datasets(chords[0], **kw)
    names = list(pds.loaders)
    assert [len(l.audio_lists[0]) for l in pds.loaders.values()] == [
        len(l.audio_lists[0]) for l in jds.loaders.values()]
    silent = 0
    for idx in range(len(pds)):
        jitem, pitem = jds[idx], pds[idx]
        _same_items(jitem, pitem, names)
        for name in names:
            if pitem[name]["path"] == "none":
                silent += 1
                assert not pitem[name]["signal"].audio_data.any()
            else:
                assert Path(pitem[name]["path"]).parent == Path(pitem[names[0]]["path"]).parent
    assert silent > 0


def test_align_lists_matches_jax():
    lists = [[{"path": "a/0.wav"}, {"path": "b/1.wav"}],
             [{"path": "a/0.wav"}, {"path": "c/1.wav"}, {"path": "b/1.wav"}],
             [{"path": "c/2.wav"}]]
    got = pd.align_lists([list(l) for l in lists])
    want = jd.align_lists([list(l) for l in lists])
    assert got == want and len({len(l) for l in got}) == 1
    assert pd.default_matcher("x/a.wav", "x/b.wav") and not pd.default_matcher("x/a", "y/a")


def test_loader_transform_and_explicit_indices_match_jax(audio_dir):
    src = [str(audio_dir / "spk.csv")]
    jl = jd.AudioLoader(sources=src, transform=jt.VolumeNorm(db=("uniform", -30, -10)))
    pl = pd.AudioLoader(sources=src, transform=pt.VolumeNorm(db=("uniform", -30, -10)))
    for kw in ({}, {"source_idx": 0, "item_idx": 1}, {"source_idx": 0, "item_idx": 99},
               {"global_idx": 5, "offset": 0.5}):
        jitem = jl(ju.random_state(4), SR, 0.25, **kw)
        pitem = pl(pu.random_state(4), SR, 0.25, **kw)
        _same_items({0: jitem}, {0: pitem}, [0])
        assert float(pitem["transform_args"]["VolumeNorm"]["db"]) == float(
            np.asarray(jitem["transform_args"]["VolumeNorm"]["db"]))
    assert pitem["signal"].device.type == "cpu"


def test_concat_dataset_matches_jax(audio_dir):
    pair = []
    for mod in (jd, pd):
        children = [mod.AudioDataset(mod.AudioLoader(sources=[str(audio_dir / f"{s}.csv")]),
                                     sample_rate=SR, n_examples=n, duration=0.25)
                    for s, n in (("spk", 3), ("nz", 2))]
        pair.append(mod.ConcatDataset(children))
    jcat, pcat = pair
    assert len(pcat) == len(jcat) == 5
    for idx in range(4):
        _same_items({0: jcat[idx]}, {0: pcat[idx]}, [0])


@pytest.mark.parametrize("n,start", [(10, None), (10, 4), (7, 6), (5, 5)])
def test_sequential_sampler_matches_jax(n, start):
    p = pd.ResumableSequentialSampler(range(n), start_idx=start)
    j = jd.ResumableSequentialSampler(range(n), start_idx=start)
    assert len(p) == len(j)
    for _ in range(2):  # the second epoch starts from 0
        assert list(p) == list(j)


@pytest.mark.parametrize("n,replicas,shuffle,drop_last,start", [
    (10, 1, False, False, None), (10, 2, False, False, 4), (7, 3, False, False, None),
    (7, 3, True, False, 3), (7, 2, True, True, None), (11, 4, False, True, 5)])
def test_distributed_sampler_matches_jax(n, replicas, shuffle, drop_last, start):
    """Every rank's sequence over two epochs (``set_epoch`` between), from
    the resume point and then from 0."""
    shards = []
    for rank in range(replicas):
        kw = dict(start_idx=start, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=7,
                  drop_last=drop_last)
        p = pd.ResumableDistributedSampler(range(n), **kw)
        j = jd.ResumableDistributedSampler(range(n), **kw)
        assert len(p) == len(j)
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            got = list(p)
            assert got == list(j)
        shards.append(got)
    assert len({len(s) for s in shards}) == 1
    if not drop_last:
        assert set(sum(shards, [])) == set(range(n))


def test_distributed_sampler_reads_its_rank_from_torch_distributed(monkeypatch):
    assert (pd.ResumableDistributedSampler(range(9)).num_replicas,
            pd.ResumableDistributedSampler(range(9)).rank) == (1, 0)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 3)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 2)
    p = pd.ResumableDistributedSampler(range(9), shuffle=True)
    assert (p.num_replicas, p.rank) == (3, 2)
    assert list(p) == list(jd.ResumableDistributedSampler(range(9), num_replicas=3, rank=2,
                                                          shuffle=True))


@pytest.fixture(scope="module")
def speech_datasets(audio_dir):
    return [mod.AudioDataset(mod.AudioLoader(sources=[str(audio_dir / "spk.csv")]),
                             sample_rate=SR, n_examples=10, duration=0.25) for mod in (jd, pd)]


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last,start", [(True, 2), (False, 2), (True, None), (False, None)])
def test_loader_sampler_and_drop_last_match_jax(speech_datasets, num_workers, drop_last, start):
    jds, pds = speech_datasets
    p = DataLoader(pds, batch_size=4, num_workers=num_workers, device="cpu", drop_last=drop_last,
                   sampler=pd.ResumableSequentialSampler(pds, start_idx=start))
    j = JDataLoader(jds, batch_size=4, num_workers=num_workers, drop_last=drop_last,
                    sampler=jd.ResumableSequentialSampler(jds, start_idx=start))
    assert len(p) == len(j)
    got, want = list(p), list(j)
    assert [b["idx"].tolist() for b in got] == [b["idx"].tolist() for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_audio(g["signal"]), _audio(w["signal"]))


def test_loader_takes_the_dataset_collate_or_the_one_given(speech_datasets):
    _, pds = speech_datasets
    assert DataLoader(pds, device="cpu").collate_fn is pds.collate
    split = DataLoader(pds, batch_size=4, device="cpu",
                       collate_fn=lambda items: pu.collate(items, n_splits=2))
    first = next(iter(split))
    assert isinstance(first, list) and [b["idx"].tolist() for b in first] == [[0, 1], [2, 3]]

    class Plain:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    assert DataLoader(Plain(), device="cpu").collate_fn is pu.collate


@pytest.mark.parametrize("num_workers", [0, 2])
def test_int16_wire_quantizes_every_signal_once(speech_datasets, num_workers):
    """Dict, list and tuple batches: every signal crosses as int16 and
    dequantizes to the float batch within int16 rounding."""
    _, pds = speech_datasets
    plain = next(iter(DataLoader(pds, batch_size=4, device="cpu")))
    collates = {
        "dict": None,
        "list": lambda items: pu.collate(items, n_splits=2),
        "tuple": lambda items: (pu.collate(items), [it["signal"] for it in items]),
    }
    for kind, fn in collates.items():
        loader = DataLoader(pds, batch_size=4, num_workers=num_workers, device="cpu",
                            collate_fn=fn, wire_dtype="int16")
        batch = next(iter(loader))
        signals = []
        pu._map_signals(batch, lambda s: signals.append(s) or s)
        assert signals and all(s.audio_data.dtype == torch.int16 for s in signals), kind
        back = pu.dequantize_batch(batch)
        whole = {"dict": back, "list": back[0] if kind == "list" else None,
                 "tuple": back[0] if kind == "tuple" else None}[kind]
        want = plain["signal"].audio_data[:2] if kind == "list" else plain["signal"].audio_data
        got = whole["signal"].audio_data
        assert float((got - want).abs().max()) <= WIRE_ERR
    with pytest.raises(ValueError):
        DataLoader(pds, device="cpu", wire_dtype="float16")


def test_silence_for_a_missing_file_stays_on_the_host(audio_dir):
    loader = pd.AudioLoader(sources=[str(audio_dir / "spk.csv")])
    item = loader(pu.random_state(0), SR, duration=0.25, num_channels=2, source_idx=0,
                  item_idx=10_000)
    assert item["path"] == "none" and item["signal"].device.type == "cpu"
    assert tuple(item["signal"].shape) == (1, 2, int(0.25 * SR))
    assert not item["signal"].audio_data.any()
    assert isinstance(AudioSignal.zeros(0.1, SR, device="cpu").audio_data, torch.Tensor)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_to_device_false_keeps_the_collated_host_batch_like_jax(speech_datasets,
                                                                      num_workers):
    """``to_device=False`` (the JAX package's default) hands over the batch
    as collated, on the host and unquantized, without asking for a card."""
    jds, pds = speech_datasets
    p = DataLoader(pds, batch_size=4, num_workers=num_workers, to_device=False,
                   wire_dtype="int16")
    j = JDataLoader(jds, batch_size=4, num_workers=num_workers, to_device=False,
                    wire_dtype="int16")
    assert p.to_device is False and p.device.type == "cpu"
    got, want = list(p), list(j)
    assert [b["idx"].tolist() for b in got] == [b["idx"].tolist() for b in want]
    for g, w in zip(got, want):
        assert g["signal"].audio_data.dtype == torch.float32
        assert g["signal"].device.type == "cpu"
        np.testing.assert_array_equal(_audio(g["signal"]), _audio(w["signal"]))


def test_loader_to_device_false_refuses_a_card_device(speech_datasets):
    """``to_device=False`` is ``device="cpu"``: a card device contradicts it."""
    with pytest.raises(ValueError, match="to_device=False"):
        DataLoader(speech_datasets[1], batch_size=4, to_device=False, device="cuda")
    loader = DataLoader(speech_datasets[1], batch_size=4, to_device=False, device="cpu")
    assert loader.device.type == "cpu" and loader.wire_dtype is None
