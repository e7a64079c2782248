"""The port's presentation layer against the JAX package's on the CPU: the
display, playback, ffmpeg and whisper mixins, ``post`` and ``preference``.

Same seeded inputs through both packages: the figures' data arrays (the
spectrogram within 2e-3 dB: the two STFTs sum in other orders, and a bin
60 dB down carries that rounding relative to itself; measured 2.8e-4 dB;
the waveform bit for bit), the HTML (embeds equal to the byte, widgets equal
once their random ids, PNG payloads and the templates' comment lines are
set aside), the r128 dicts within the meters' 1e-3 dB pin
(tests/test_torch_meter.py), the resample within its 1e-5 pin
(tests/test_torch_ops.py), the Whisper features, transcript and
embeddings from one tiny random-weight checkpoint built offline (the JAX
package's fixture, tests/core/test_whisper_real.py; nothing downloaded),
and the preference app driven through a gradio stub (the JAX package's,
tests/test_preference_app.py). Clips are at most 0.5 s.
"""
import csv
import importlib.util
import re
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal  # noqa: E402
from audiotools_tpu import post as jpost  # noqa: E402
from audiotools_tpu import preference as jpr  # noqa: E402
from audiotools_tpu.core import ffmpeg as jffmpeg  # noqa: E402
from audiotools_tpu.core import util as ju  # noqa: E402
from audiotools_tpu_torch import AudioSignal, post, preference as pr  # noqa: E402
from audiotools_tpu_torch.core import ffmpeg as pffmpeg  # noqa: E402
from audiotools_tpu_torch.core import playback as pplayback  # noqa: E402
from audiotools_tpu_torch.core import util as pu  # noqa: E402
from tests.core.test_whisper_real import tiny_whisper_checkpoint  # noqa: E402,F401
from tests.fixtures import speech_like  # noqa: E402
from tests.test_preference_app import gradio_stub  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
SR = 22050
SPEC_DB = 2e-3
LUFS_DB = 1e-3
RESAMPLE_ABS = 1e-5


def _x(seed=0, batch=1, channels=1, duration=0.5, sr=SR):
    return np.stack([np.stack([speech_like(seed + b * channels + c, duration, sr)
                               for c in range(channels)]) for b in range(batch)])


def _pair(x, sr=SR):
    return AudioSignal(x.copy(), sr, device="cpu"), JSignal(x.copy(), sr)


def _drawn(draw):
    """Draw on a fresh figure; return its axes' images, collections and
    texts as arrays and strings."""
    plt.figure()
    try:
        draw()
        fig = plt.gcf()
        return [{"images": [(np.asarray(im.get_array()), tuple(im.get_extent()))
                            for im in ax.images],
                 "paths": [p.vertices.copy() for c in ax.collections for p in c.get_paths()],
                 "texts": [t.get_text() for t in ax.texts],
                 "yscale": ax.get_yscale()} for ax in fig.axes], tuple(fig.get_size_inches())
    finally:
        plt.close("all")


def _same_figure(got, want, image_atol):
    (axes, size), (jaxes, jsize) = got, want
    assert size == jsize and len(axes) == len(jaxes)
    for a, j in zip(axes, jaxes):
        assert a["yscale"] == j["yscale"] and len(a["images"]) == len(j["images"])
        for (im, extent), (jim, jextent) in zip(a["images"], j["images"]):
            assert im.shape == jim.shape and extent == pytest.approx(jextent)
            assert np.abs(im - jim).max() <= image_atol
        assert len(a["paths"]) == len(j["paths"])
        for p, jp in zip(a["paths"], j["paths"]):
            np.testing.assert_array_equal(p, jp)
        assert len(a["texts"]) == len(j["texts"])


# -- display ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"preemphasis": True}, {"y_axis": "mel"},
                                    {"y_axis": "log"}, {"title": "hello"}, {"format": False},
                                    {"x_axis": "frames", "fig_size": (6, 2)}])
def test_specshow_draws_the_jax_packages_figure(kwargs):
    p, j = _pair(_x(1, channels=2))
    _same_figure(_drawn(lambda: p.specshow(**kwargs)), _drawn(lambda: j.specshow(**kwargs)),
                 SPEC_DB)


@pytest.mark.parametrize("method", ["waveplot", "wavespec"])
def test_waveform_plots_match_jax(method):
    p, j = _pair(_x(2))
    _same_figure(_drawn(lambda: getattr(p, method)(title="w")),
                 _drawn(lambda: getattr(j, method)(title="w")), SPEC_DB)


def test_format_figure_annotates_like_jax():
    def draw(util):
        plt.imshow(np.arange(12.0).reshape(3, 4), extent=[0, 4, 0, 8000], aspect="auto")
        util.format_figure(fig_size=(5, 2), title="t")

    _same_figure(_drawn(lambda: draw(pu)), _drawn(lambda: draw(ju)), 0.0)


@pytest.mark.parametrize("plot_fn", ["specshow", "waveplot"])
def test_save_image_matches_jax(tmp_path, plot_fn):
    p, j = _pair(_x(3))
    p.save_image(str(tmp_path / "p.png"), plot_fn=plot_fn)
    j.save_image(str(tmp_path / "j.png"), plot_fn=plot_fn)
    got, want = plt.imread(tmp_path / "p.png"), plt.imread(tmp_path / "j.png")
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < 1e-3


class _Writer:
    def __init__(self):
        self.calls = []

    def add_audio(self, tag, samples, step, rate):
        self.calls.append(("audio", tag, samples.numpy().copy(), step, rate))

    def add_figure(self, tag, fig, step):
        self.calls.append(("figure", tag, fig.get_size_inches().tolist(), step))


def test_write_audio_to_tb_matches_jax():
    p, j = _pair(_x(4, batch=2))
    got, want = _Writer(), _Writer()
    p.write_audio_to_tb("val/sample_0.wav", got, step=3)
    j.write_audio_to_tb("val/sample_0.wav", want, step=3)
    plt.close("all")
    assert len(got.calls) == len(want.calls) == 2
    for g, w in zip(got.calls, want.calls):
        assert g[0] == w[0] and g[1] == w[1] and g[-1] == w[-1]
        if g[0] == "audio":
            np.testing.assert_array_equal(g[2], w[2])
            assert g[3] == w[3]


def test_tensorboard_writes(tmp_path):
    from torch.utils.tensorboard import SummaryWriter

    writer = SummaryWriter(str(tmp_path / "tb"))
    AudioSignal(_x(5), SR, device="cpu").write_audio_to_tb("a.wav", writer, step=0,
                                                           plot_fn="waveplot")
    writer.close()
    plt.close("all")
    assert any((tmp_path / "tb").iterdir())


# -- playback ------------------------------------------------------------------------


def test_embed_matches_jax():
    p, j = _pair(_x(6))
    assert p.embed(display=False, return_html=True) == j.embed(display=False, return_html=True)
    assert p.embed(display=False).data == j.embed(display=False).data


def _template_drift():
    """Lines of the two packages' templates that differ (comments naming
    the original library's files)."""
    drift = set()
    for name in ("headers.html", "widget.html"):
        mine = (ROOT / "audiotools_tpu_torch/core/templates" / name).read_text().splitlines()
        theirs = (ROOT / "audiotools_tpu/core/templates" / name).read_text().splitlines()
        drift |= set(mine) ^ set(theirs)
    return drift


def _normalized(html, drift):
    html = re.sub(r"data:image/png;base64,[A-Za-z0-9+/=]+", "PNG", html)
    html = re.sub(r"\bat[0-9a-f]{12}\b", "ID", html)
    return [line for line in html.splitlines() if line not in drift]


@pytest.mark.parametrize("add_headers", [True, False])
def test_widget_html_matches_jax(add_headers):
    p, j = _pair(_x(7))
    got = p.widget("T", add_headers=add_headers, return_html=True)
    want = j.widget("T", add_headers=add_headers, return_html=True)
    plt.close("all")
    drift = _template_drift()
    assert len(drift) <= 12  # comment lines only
    assert _normalized(got, drift) == _normalized(want, drift)
    assert ("function atSetupPlayer" in got) == add_headers


def test_play_uses_the_players_the_jax_package_uses(monkeypatch):
    from audiotools_tpu.core import playback as jplayback

    import shutil

    p, j = _pair(_x(8, duration=0.1))
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None if name in ("ffplay", "aplay")
                        else which(name))
    with pytest.raises(RuntimeError, match="No audio player"):
        p.play()
    calls = []
    monkeypatch.setattr(shutil, "which", lambda name: name == "aplay" or which(name)
                        if name != "ffplay" else None)
    for module in (pplayback, jplayback):
        monkeypatch.setattr(module.subprocess, "call", lambda cmd: calls.append(cmd[:-1]))
    assert p.play() is p and j.play() is j
    assert calls == [["aplay"], ["aplay"]]


# -- ffmpeg -------------------------------------------------------------------------


@pytest.fixture
def no_ffmpeg(monkeypatch):
    """The native routes, also on a host that has the binaries."""
    import shutil

    which = shutil.which
    monkeypatch.setattr(shutil, "which",
                        lambda name: None if name in ("ffmpeg", "ffprobe") else which(name))


@pytest.mark.parametrize("subtype,channels", [("FLOAT", 1), ("PCM_16", 2)])
def test_r128stats_matches_jax(tmp_path, no_ffmpeg, subtype, channels):
    path = tmp_path / "x.wav"
    AudioSignal(_x(9, channels=channels), SR, device="cpu").write(path, subtype=subtype)
    got = pffmpeg.r128stats(str(path), device="cpu")
    want = jffmpeg.r128stats(str(path))
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) < LUFS_DB, key
    assert pffmpeg.ffprobe_offset_and_codec(str(path)) == jffmpeg.ffprobe_offset_and_codec(
        str(path))


def test_ffmpeg_loudness_matches_jax_and_the_meter(no_ffmpeg):
    x = _x(10, batch=3)
    p, j = _pair(x)
    got = p.ffmpeg_loudness()
    assert got.shape == (3,) and got.device == p.device and got is p.loudness()
    assert np.abs(got.numpy() - np.asarray(j.ffmpeg_loudness())).max() < LUFS_DB
    direct = AudioSignal(x, SR, device="cpu").loudness().numpy()
    assert np.abs(got.numpy() - direct).max() < 0.2  # the JAX package's pin: a 16-bit file


@pytest.mark.parametrize("rate", [16000, 44100, SR])
def test_ffmpeg_resample_matches_jax(no_ffmpeg, rate):
    p, j = _pair(_x(11))
    got, want = p.ffmpeg_resample(rate), j.ffmpeg_resample(rate)
    assert got is p and got.sample_rate == want.sample_rate == rate
    assert got.signal_length == want.signal_length
    assert np.abs(got.audio_data.numpy() - np.asarray(want.audio_data)).max() < RESAMPLE_ABS


@pytest.mark.parametrize("suffix", [".flac", ".wav", ".mp3"])
def test_load_from_file_with_ffmpeg_matches_jax(tmp_path, no_ffmpeg, suffix):
    from audiotools_tpu.io import codecs as jcodecs

    if suffix == ".mp3" and not jcodecs.mp3_available():
        pytest.skip("no mp3 libraries")
    path = tmp_path / f"y{suffix}"
    AudioSignal(_x(12, channels=2), SR, device="cpu").write(path)
    got = AudioSignal.load_from_file_with_ffmpeg(str(path), device="cpu")
    want = JSignal.load_from_file_with_ffmpeg(str(path))
    assert got.device.type == "cpu" and got.sample_rate == want.sample_rate
    np.testing.assert_array_equal(got.audio_data.numpy(), np.asarray(want.audio_data))
    np.testing.assert_array_equal(got.audio_data.numpy(),
                                  AudioSignal(path, device="cpu").audio_data.numpy())


# -- whisper --------------------------------------------------------------------------


@pytest.fixture
def whisper_pair(tiny_whisper_checkpoint):  # noqa: F811
    t = np.arange(int(SR * 0.5)) / SR
    audio = sum(0.2 / (k + 1) * np.sin(2 * np.pi * 220 * (k + 1) * t) for k in range(4))
    x = (audio * np.exp(-t)).astype(np.float32)[None, None]
    p, j = _pair(x)
    for sig in (p, j):
        with pytest.warns(UserWarning, match="experimental"):
            sig.setup_whisper(tiny_whisper_checkpoint, **({"device": "cpu"} if sig is j else {}))
    return p, j


def test_whisper_model_goes_to_the_signals_device(whisper_pair):
    p, _ = whisper_pair
    assert p.whisper_device == p.device
    assert next(p.whisper_model.parameters()).device == p.device


def test_whisper_features_match_jax(whisper_pair):
    p, j = whisper_pair
    got, want = p.get_whisper_features(), j.get_whisper_features()
    assert tuple(got.shape) == tuple(want.shape) == (1, 80, 3000)
    assert float((got - want).abs().max()) < 1e-4


def test_whisper_transcript_and_embeddings_match_jax(whisper_pair):
    p, j = whisper_pair
    assert p.get_whisper_transcript() == j.get_whisper_transcript()
    got, want = p.get_whisper_embeddings(), j.get_whisper_embeddings()
    assert tuple(got.shape) == (1, 1500, 64)
    assert float((got - want).abs().max()) < 1e-3
    assert torch.equal(got, p.get_whisper_embeddings())


# -- post ------------------------------------------------------------------------------


def _table_dicts():
    x = _x(13, batch=2, duration=0.1)
    p, j = _pair(x)
    return ({0: {"input": p[0], "output": p[1], "label": 3, "score": torch.tensor([0.5, 1.0])},
             1: {"input": p[1], "output": None, "label": "x", "score": torch.tensor([2.0])}},
            {0: {"input": j[0], "output": j[1], "label": 3, "score": np.array([0.5, 1.0])},
             1: {"input": j[1], "output": None, "label": "x", "score": np.array([2.0])}})


@pytest.mark.parametrize("first_column", [None, "item"])
def test_audio_table_matches_jax(first_column):
    mine, theirs = _table_dicts()
    got = post.audio_table(mine, first_column=first_column)
    assert got == jpost.audio_table(theirs, first_column=first_column)
    assert "<audio" in got
    assert post._markdown_table_to_html(got) == jpost._markdown_table_to_html(got)
    flat_p, flat_j = _pair(_x(14, duration=0.1))
    assert post.audio_table({"a": flat_p}) == jpost.audio_table({"a": flat_j})


def test_disp_prints_like_jax(capsys):
    mine, theirs = _table_dicts()
    assert post.in_notebook() is jpost.in_notebook() is False
    outs = []
    for module, table in ((post, mine), (jpost, theirs)):
        module.disp(table[0]["input"])
        module.disp(table)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "<audio" in outs[0]


# -- preference ----------------------------------------------------------------------------


def _tree(root, conditions=("cond_a", "cond_b", "ref"), n=3):
    for c in conditions:
        for k in range(n):
            path = root / c / f"sample_{k}.wav"
            path.parent.mkdir(parents=True, exist_ok=True)
            x = np.sin(2 * np.pi * 110 * (k + 1) * np.arange(4000) / 8000).astype(np.float32)
            AudioSignal(x[None, None] * 0.1, 8000, device="cpu").write(path)
    return root


@pytest.mark.parametrize("shuffle", [False, True])
def test_samples_serve_like_jax(tmp_path, shuffle):
    import random

    _tree(tmp_path)
    random.seed(3)
    mine = pr.Samples(str(tmp_path), shuffle=shuffle)
    random.seed(3)
    theirs = jpr.Samples(str(tmp_path), shuffle=shuffle)
    assert mine.names == theirs.names and len(mine) == len(theirs) == 3
    for _ in range(4):
        random.seed(len(mine.names) + mine.current)
        got = mine.get_next_sample("ref", ["cond_a", "cond_b"])
        random.seed(len(theirs.names) + theirs.current)
        want = theirs.get_next_sample("ref", ["cond_a", "cond_b"])
        assert got == want and mine.order == theirs.order
    assert mine.progress() == theirs.progress()


def test_filter_completed_and_results_match_jax(tmp_path):
    _tree(tmp_path / "audio")
    rows = [{"sample": "sample_1.wav", "user": "u1", "cond_a": 80},
            {"sample": "sample_0.wav", "user": "other", "cond_a": 10}]
    for module, name in ((pr, "p.csv"), (jpr, "j.csv")):
        for row in rows:
            module.save_result(row, tmp_path / name)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    mine = pr.Samples(str(tmp_path / "audio"), shuffle=False)
    theirs = jpr.Samples(str(tmp_path / "audio"), shuffle=False)
    mine.filter_completed("u1", str(tmp_path / "p.csv"))
    theirs.filter_completed("u1", str(tmp_path / "j.csv"))
    assert mine.names == theirs.names and "sample_1.wav" not in mine.names


@pytest.mark.parametrize("name", ["CUSTOM_CSS", "PLAYER_HTML", "player_js", "clear_regions",
                                  "reset_player", "loop_region", "progress_template",
                                  "slider_abx", "slider_mushra"])
def test_player_markup_matches_jax(name):
    assert getattr(pr, name) == getattr(jpr, name)


def test_trackers_and_players_match_jax():
    assert pr.load_tracker("id") == jpr.load_tracker("id")
    assert pr.play(2) == jpr.play(2)
    try:
        import gradio  # noqa: F401

        pytest.skip("gradio installed: the app test drives the player")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="gradio"):
        pr.Player(app=None)


def _example(name, preference_module):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pr = preference_module
    return module


def test_mushra_app_runs_on_the_port_like_jax(tmp_path, gradio_stub):  # noqa: F811
    """The JAX package's examples/mushra.py, its preference module swapped
    for the port's, driven through a whole session beside the original."""
    import random

    _tree(tmp_path / "audio", conditions=("ref", "a", "b"))
    results = []
    for module, name in ((pr, "p.csv"), (jpr, "j.csv")):
        gradio_stub["clicks"].clear()
        random.seed(0)
        app = _example("mushra", module)
        app.main(app.Config(folder=str(tmp_path / "audio"), save_path=str(tmp_path / name),
                            conditions=["a", "b"], reference="ref", n_samples=3))
        (click,) = gradio_stub["clicks"]
        samples = click["inputs"][1].value
        assert isinstance(samples, module.Samples)
        served = []
        for k in range(4):
            random.seed(k)
            updates = click["fn"]("user-1", samples, 10 * k, 100 - 10 * k)
            served.append([u.get("value") for u in updates[:3]])
        results.append((served, samples.progress()["value"]))
    assert results[0] == results[1]
    with open(tmp_path / "p.csv") as f:
        rows = list(csv.DictReader(f))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert len(rows) == 3 and {r["user"] for r in rows} == {"user-1"}
    assert gradio_stub["launched"]


def test_post_and_preference_import_no_ui_library():
    import subprocess

    probe = ("import sys; import audiotools_tpu_torch.post, audiotools_tpu_torch.preference, "
             "audiotools_tpu_torch.core.display, audiotools_tpu_torch.core.playback, "
             "audiotools_tpu_torch.core.whisper, audiotools_tpu_torch.core.ffmpeg; "
             "print(sorted(m for m in ('matplotlib', 'IPython', 'transformers', 'gradio', "
             "'tensorboard') if m in sys.modules))")
    done = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "[]"
