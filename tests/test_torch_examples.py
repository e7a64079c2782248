"""The port's example scripts (``audiotools_tpu_torch/examples``) against the
JAX package's (``examples/``).

``codec`` compresses and decompresses a seeded fixture on the CPU with the
toy model, and its artifact is the JAX package's file format. ``abx`` and
``mushra`` build their apps through the gradio stub of
``tests/test_preference_app.py`` and are driven through a session beside the
JAX package's scripts, which must serve the same samples and write the same
results.
"""
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.models import load_artifact as j_load_artifact
from audiotools_tpu_torch.examples import abx, codec, mushra
from audiotools_tpu_torch.examples.train_dac import TOY_DAC
from audiotools_tpu_torch.io import read_wav, write_wav
from audiotools_tpu_torch.models import DAC
from tests.test_preference_app import gradio_stub  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SR = 44100


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def clip(tmp_path):
    x = (np.random.RandomState(0).randn(1, SR) * 0.1).astype(np.float32)
    path = tmp_path / "in.wav"
    write_wav(path, x, SR)
    return path


@pytest.mark.parametrize("streaming", [False, True])
def test_codec_toy_compresses_and_decompresses(tmp_path, clip, streaming):
    """``--toy`` on the host: the artifact holds the toy model's codes (the
    streamed pass's equal the whole pass's), reads back through the JAX
    package's loader, and decompresses to a WAV of the input's length."""
    flags = ["--toy", "--device", "cpu"] + (["--streaming"] if streaming else [])
    art = codec.main(["compress", str(clip), str(tmp_path / "c.dacz.npz"), *flags])
    audio = torch.from_numpy(read_wav(clip)[0])[None]
    with torch.no_grad():
        _, codes = DAC(**TOY_DAC, sample_rate=SR).encode(audio)
    assert art["codes"].dtype == np.uint16
    assert np.array_equal(art["codes"], codes.numpy())
    loaded = j_load_artifact(str(tmp_path / "c.dacz.npz"))
    assert loaded.keys() == art.keys()
    assert all(np.array_equal(loaded[k], art[k]) for k in art)

    recon = codec.main(["decompress", str(tmp_path / "c.dacz.npz"), str(tmp_path / "out.wav"),
                        *flags])
    data, sr = read_wav(tmp_path / "out.wav")
    assert sr == SR and data.shape == (1, SR) and recon.device.type == "cpu"
    assert np.isfinite(data).all()


def test_codec_model_folder_and_bitrate(tmp_path, clip, capsys):
    """``--model`` loads a ``save_to_folder`` layout; ``--n-quantizers``
    keeps a prefix of the cascade; neither flag refuses."""
    DAC(**TOY_DAC, sample_rate=SR, seed=5).save_to_folder(tmp_path / "model")
    art = codec.main(["compress", str(clip), str(tmp_path / "c.npz"), "--model",
                      str(tmp_path / "model"), "--n-quantizers", "2", "--device", "cpu"])
    assert art["codes"].shape[1] == art["n_codebooks"] == 2
    assert "smaller than 16-bit PCM" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--toy"):
        codec.main(["compress", str(clip), str(tmp_path / "d.npz"), "--device", "cpu"])


def test_abx_data_matches_jax(tmp_path):
    abx.create_data(tmp_path / "port")
    _jax_example("abx").create_data(tmp_path / "jax")
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav"))
    assert len(files) == 18
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _session(app, config, answers, stub):
    """Build ``app`` with ``config`` through the stub and submit ``answers``:
    what each submission served, and the results file."""
    stub["clicks"].clear()
    random.seed(0)
    app.main(config)
    (click,) = stub["clicks"]
    samples = click["inputs"][1].value
    served = []
    for k, answer in enumerate(answers):
        random.seed(k)
        updates = click["fn"]("user-1", samples, *answer)
        served.append([u.get("value") for u in updates[:3]])
    return served, Path(config.save_path).read_text()


def test_abx_app_runs_like_jax(tmp_path, gradio_stub):  # noqa: F811
    abx.create_data(tmp_path / "audio")
    runs = []
    for module, name in ((abx, "p.csv"), (_jax_example("abx"), "j.csv")):
        config = module.Config(folder=str(tmp_path / "audio"), save_path=str(tmp_path / name),
                               conditions=["condition_a", "condition_b"],
                               reference="condition_c")
        runs.append(_session(module, config, [(10 * k,) for k in range(4)], gradio_stub))
    assert runs[0] == runs[1]
    assert runs[0][1].count("user-1") == 3
    assert gradio_stub["launched"]
    with pytest.raises(ValueError, match="two conditions"):
        abx.main(abx.Config(folder=str(tmp_path / "audio"), conditions=["condition_a"]))


def test_mushra_app_runs_like_jax(tmp_path, gradio_stub):  # noqa: F811
    abx.create_data(tmp_path / "audio")
    (tmp_path / "audio" / "condition_a" / "sample_0.txt").write_text("a transcript")
    runs = []
    for module, name in ((mushra, "p.csv"), (_jax_example("mushra"), "j.csv")):
        config = module.Config(folder=str(tmp_path / "audio"), save_path=str(tmp_path / name),
                               conditions=["condition_a", "condition_b"],
                               reference="condition_c", n_samples=3)
        answers = [(10 * k, 100 - 10 * k) for k in range(4)]
        runs.append(_session(module, config, answers, gradio_stub))
    assert runs[0] == runs[1]
    assert runs[0][1].count("user-1") == 3
    config = mushra.parse_args(["--folder", "f", "--conditions", "a", "b", "--share",
                                "--n_samples", "4"])
    assert config == mushra.Config(folder="f", conditions=["a", "b"], share=True, n_samples=4)
