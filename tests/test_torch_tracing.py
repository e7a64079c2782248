"""The program's spans (``audiotools_tpu_torch._hostprof.span``) on the CPU.

A span has two sinks: exclusive host totals after ``enable()``, and a
``torch.profiler`` range named ``"audiotools." + name`` while the profiler
records. With neither on it makes nothing. Under ``torch.profiler.profile``
the chain's transforms, the BS.1770 meter, the adversarial step's phases,
the DAC's stages and the codec's ``compress``/``decompress`` each give
their range, nested as the calls nest.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from audiotools_tpu_torch import _hostprof as hostprof  # noqa: E402
from audiotools_tpu_torch.core import util  # noqa: E402
from audiotools_tpu_torch.data import transforms as tfm  # noqa: E402
from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader  # noqa: E402
from audiotools_tpu_torch.ops import loudness as PL  # noqa: E402

SR = 44100
TINY_DAC = dict(encoder_dim=8, encoder_rates=(2, 4, 8, 8), latent_dim=32, decoder_dim=64,
                n_codebooks=4, codebook_size=64, codebook_dim=8)
TINY_DISC = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8, 16, 32),
                 mrd_channels=4)
DAC_STAGES = ("audiotools.dac.encoder", "audiotools.dac.quantizer", "audiotools.dac.decoder")


def _ranges(prof):
    """The program's ranges in a finished profile: ``(name, start, end,
    thread)`` sorted by start, outer before inner."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("audiotools.")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _names(ranges):
    return [r[0] for r in ranges]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _recorded():
    return profile(activities=[ProfilerActivity.CPU])


class _Unjoinable:
    """A name part that fails if anything tries to build the name."""

    def __str__(self):
        raise AssertionError("the span's name was built")


def test_span_with_both_sinks_off_makes_nothing(monkeypatch):
    hostprof.disable()
    hostprof.reset()
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: made.append(a))
    with hostprof.span("transform", _Unjoinable()):
        pass
    with hostprof.span("loudness"):
        pass
    assert made == [] and hostprof.totals() == {} and hostprof.ranges() == []
    # no object of its own either: every span off is one shared no-op
    assert hostprof.span("a") is hostprof.span("b", "c")


def test_span_is_a_range_while_the_profiler_records():
    hostprof.disable()
    hostprof.reset()
    with _recorded() as prof:
        with hostprof.span("outer"):
            with hostprof.span("transform", "Compose"):
                torch.ones(3).add_(1)
    ranges = _ranges(prof)
    assert _names(ranges) == ["audiotools.outer", "audiotools.transform.Compose"]
    assert _inside(ranges[1], ranges[0])
    assert hostprof.totals() == {}  # the totals' sink stays off


def test_ranges_keep_each_interval_made_under_the_profiler():
    import threading
    import time

    hostprof.disable()
    hostprof.reset()
    with hostprof.span("before"):
        pass
    t0 = time.perf_counter_ns()
    with _recorded():
        with hostprof.span("outer"):
            with hostprof.span("transform", "Compose"):
                time.sleep(0.01)
    t1 = time.perf_counter_ns()
    kept = hostprof.ranges()
    # oldest first: a span is kept when it closes
    assert [r[0] for r in kept] == ["transform.Compose", "outer"]
    (_, c0, c1, tid), (_, o0, o1, _) = kept
    assert t0 < o0 <= c0 < c1 <= o1 < t1 and c1 - c0 >= 10_000_000
    assert tid == threading.get_ident()
    hostprof.reset()
    assert hostprof.ranges() == []


def test_totals_stay_exclusive_with_the_profiler_on():
    import time

    hostprof.reset()
    hostprof.enable()
    try:
        with _recorded() as prof:
            with hostprof.span("outer"):
                time.sleep(0.02)
                with hostprof.span("transform", "VolumeNorm"):
                    time.sleep(0.03)
    finally:
        hostprof.disable()
    t = hostprof.totals()
    hostprof.reset()
    assert set(t) == {"outer", "transform.VolumeNorm"}
    # the outer span's own time only: with its child it would be >= 0.05 s
    assert 0.015 < t["outer"] < 0.045 and t["transform.VolumeNorm"] >= 0.025
    assert _names(_ranges(prof)) == ["audiotools.outer", "audiotools.transform.VolumeNorm"]


@pytest.fixture
def counted_meters(monkeypatch):
    """Counts the calls of the device meter's two entry points; callers
    look them up on the module, so they go through the counters."""
    calls = []
    for name in ("loudness", "integrated_loudness"):
        fn = getattr(PL, name)

        def counted(*args, _fn=fn, **kwargs):
            calls.append(_fn)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(PL, name, counted)
    return calls


def _chain_batch(audio_dir):
    """The chain of the north-star workload on two 1 s clips, drawn by the
    dataset from the fixture tree, on the CPU."""
    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(audio_dir / "ir.csv")]),
        tfm.BackgroundNoise(sources=[str(audio_dir / "nz.csv")]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    ds = AudioDataset(AudioLoader(sources=[str(audio_dir / "spk.csv")]), sample_rate=SR,
                      n_examples=4, duration=1.0, transform=transform)
    return ds, util.collate([ds[i] for i in (0, 1)])


def test_chain_batch_gives_each_transform_and_each_meter_call_a_range(audio_dir,
                                                                       counted_meters):
    ds, batch = _chain_batch(audio_dir)
    with _recorded() as prof:
        out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
        PL.loudness(out.audio_data, SR)  # the features' meter
    ranges = _ranges(prof)
    transforms = [r for r in ranges if r[0].startswith("audiotools.transform.")]
    assert _names(transforms) == ["audiotools.transform." + n for n in (
        "Compose", "RoomImpulseResponse", "BackgroundNoise", "Equalizer", "VolumeNorm")]
    compose, children = transforms[0], transforms[1:]
    assert all(_inside(child, compose) for child in children)
    assert all(not _inside(b, a) for a, b in zip(children, children[1:]))
    meters = [r for r in ranges if r[0] == "audiotools.loudness"]
    # the noise's stacked meter, VolumeNorm's, the features'
    assert len(meters) == len(counted_meters) == 3
    by_name = dict((r[0], r) for r in children)
    assert _inside(meters[0], by_name["audiotools.transform.BackgroundNoise"])
    assert _inside(meters[1], by_name["audiotools.transform.VolumeNorm"])
    assert not _inside(meters[2], compose)
    assert np.isfinite(out.audio_data.numpy()).all()


def test_masked_path_is_the_same_span():
    """A transform applied to some items only (the masked path) gives its
    range too."""
    from audiotools_tpu_torch import AudioSignal

    t = tfm.VolumeChange(prob=0.5)
    signal = AudioSignal(torch.randn(2, 1, 4410) * 0.1, SR, device="cpu")
    kwargs = util.collate([t.instantiate(s) for s in (0, 1)])
    kwargs["VolumeChange"]["mask"] = torch.tensor([True, False])
    with _recorded() as prof:
        t(signal.clone(), **kwargs)
    assert _names(_ranges(prof)) == ["audiotools.transform.VolumeChange"]


def _tiny_models():
    from audiotools_tpu_torch.models import DAC, Discriminator

    return DAC(**TINY_DAC, sample_rate=SR), Discriminator(**TINY_DISC)


def test_adversarial_step_gives_its_phases_with_the_dac_inside_the_generator():
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step

    gen, disc = _tiny_models()
    g_opt, d_opt = (torch.optim.AdamW(m.parameters(), lr=1e-4) for m in (gen, disc))
    step = make_adversarial_train_step(gen, disc, g_opt, d_opt, SR)
    audio = torch.randn(2, 1, 2048, generator=torch.Generator().manual_seed(0)) * 0.1
    with _recorded() as prof:
        metrics = step(audio)
    assert all(torch.isfinite(v) for v in metrics.values())
    ranges = _ranges(prof)
    phases = [r for r in ranges if not r[0].startswith("audiotools.dac.")
              and r[0] != "audiotools.loudness"]
    assert _names(phases) == ["audiotools." + n for n in (
        "optimizer", "generator", "discriminator", "backward", "optimizer",
        "optimizer", "discriminator", "backward", "optimizer")]
    generator = phases[1]
    stages = [r for r in ranges if r[0].startswith("audiotools.dac.")]
    assert _names(stages) == list(DAC_STAGES)
    assert all(_inside(r, generator) for r in stages)
    # the phases follow one another
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_compress_and_decompress_hold_the_dac_stages():
    from audiotools_tpu_torch.models.artifacts import compress, decompress

    gen, _ = _tiny_models()
    gen = gen.eval()
    audio = torch.randn(1, 1, 3000, generator=torch.Generator().manual_seed(1)) * 0.1
    with _recorded() as prof:
        art = compress(gen, audio)
        out = decompress(gen, art)
    assert out.audio_data.shape[-1] == 3000
    ranges = _ranges(prof)
    assert _names(ranges) == ["audiotools.compress", "audiotools.dac.encoder",
                              "audiotools.dac.quantizer", "audiotools.decompress",
                              "audiotools.dac.quantizer", "audiotools.dac.decoder"]
    assert all(_inside(r, ranges[0]) for r in ranges[1:3])
    assert all(_inside(r, ranges[3]) for r in ranges[4:])
