"""The comparison that decides ``correct``, on the CPU at small sizes: each
plain reference agrees with the program; the control (the reference a
precision lower, in the program's place) fails the limits; and a run whose
timed path is broken underneath reads ``correct`` false, for each fault the
cell can have. The runs go through ``run.execute``, past the look for a
card, with the cells' configurations and mixes cut to a test's size."""
import contextlib
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from perfbench import run  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

TINY_DAC = dict(encoder_dim=8, encoder_rates=[2, 4, 8, 8], latent_dim=32, decoder_dim=64,
                n_codebooks=4, codebook_size=64, codebook_dim=8)
TINY_DISC = dict(periods=[2, 3], fft_sizes=[256, 128], mpd_channels=[4, 8, 16, 32],
                 mrd_channels=4)


def tiny(cell):
    """The cell's configuration and mix at a test's size."""
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    config_file = next(c["file"] for c in SPEC["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / config_file).read_text())
    mix = json.loads((ROOT / "perfbench" / "mixes" / f"{w['traffic']}.json").read_text())
    if mix["driver"] == "chain":
        config.update(batch=4, clip_seconds=1.0)
        mix.update(pool=1, loader_workers=2, trace_iterations=2,
                   corpora={k: dict(v, seconds=min(v["seconds"], 2.0))
                            for k, v in mix["corpora"].items()})
    elif mix["driver"] == "train":
        config.update(widths=TINY_DAC, discriminator=TINY_DISC, batch_size=4, samples=2048)
        mix.update(pool=4, trace_iterations=2)
    else:
        config.update(widths=TINY_DAC)
        mix.update(min_seconds=0.2, max_seconds=0.6, n_lengths=3, judged_requests=2,
                   trace_iterations=4)
    return w, config, mix


def execute(cell, seconds=1.5, trace=0, seed=2**31 + 17):
    w, config, mix = tiny(cell)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    e2e = [m for m in SPEC["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    layer = [m for m in SPEC["per_layer"] if "workloads" not in m or cell in m["workloads"]]
    return run.execute(args, w, config, mix, e2e, layer)


CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell):
    result, compared = execute(cell)
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    e2e = {m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(result["metrics"]) == e2e


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_layers(cell):
    result, _ = execute(cell, trace=1)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # host spans are read on the CPU too; device metrics find nothing here
    if cell.startswith("augment."):
        assert any(name.startswith("enqueue_ms.") for name in result["metrics"])


def _control(cell, seed=2**31 + 23):
    """The driver's control numbers after a short window of a tiny cell."""
    from perfbench.harness.spans import Spans

    w, config, mix = tiny(cell)
    driver = run.load_module(run.BENCH / "drivers" / f"{mix['driver']}.py",
                             f"perfbench.drivers.{mix['driver']}")
    state = driver.setup(config, mix, seed, Spans(False))
    try:
        window = driver.window(state, 2.0, Spans(False))
        return driver.control(state), mix["limits"], window
    finally:
        driver.close(state)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    numbers, limits, _ = _control(cell)
    failed = {k for k, v in numbers.items() if not v <= limits[k]}
    assert failed, numbers
    if cell.startswith("augment."):
        # every number has an upper reading; the codec's code gap needs the
        # cell's size for TF32 to flip a code (PERF.md's readings)
        assert failed == set(limits), numbers


@contextlib.contextmanager
def patched(obj, name, make):
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def _altered(fn):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        out = out.clone()
        out.view(-1)[out.numel() // 2] += 0.05 * out.abs().max()
        return out
    return call


def _half_batch(fn):
    """Half the batch left out: the first half computed, its mean in the
    other half's place."""
    def call(audio, *args, **kwargs):
        half = audio.shape[0] // 2
        out = fn(audio[:half], *args, **kwargs)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)], 0)
    return call


def _chain_faults():
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import stretch as PS

    yield "answer_altered", lambda: patched(PF, "mel_spectrogram", _altered)
    yield "half_batch", lambda: patched(PS, "pitch_shift", _half_batch)


def _codec_faults():
    from audiotools_tpu_torch.models import artifacts

    def altered_code(fn):
        def call(*args, **kwargs):
            art = fn(*args, **kwargs)
            art["codes"] = art["codes"].copy()
            art["codes"][0, 0, 0] = (int(art["codes"][0, 0, 0]) + 1) % art["codebook_size"]
            return art
        return call

    yield "code_altered", lambda: patched(artifacts, "compress", altered_code)


def _train_faults():
    from audiotools_tpu_torch.models import adversarial

    def unchanged(make):
        def build(gen, disc, g_opt, d_opt, sr):
            step = make(gen, disc, g_opt, d_opt, sr)
            g_opt.step = d_opt.step = lambda *a, **k: None
            return step
        return build

    def half_batch(make):
        def build(*args):
            step = make(*args)
            return lambda audio: step(audio[: audio.shape[0] // 2])
        return build

    yield "state_unchanged", lambda: patched(adversarial, "make_adversarial_train_step", unchanged)
    yield "half_batch", lambda: patched(adversarial, "make_adversarial_train_step", half_batch)


def _faults():
    for cell in CELLS:
        kind = json.loads((ROOT / "perfbench" / "mixes" / (
            next(w["traffic"] for w in SPEC["workloads"] if w["name"] == cell) + ".json")
        ).read_text())["driver"]
        source = {"chain": _chain_faults, "codec": _codec_faults, "train": _train_faults}[kind]
        for name, fault in source():
            yield pytest.param(cell, fault, id=f"{cell}-{name}")


@pytest.mark.parametrize("cell,fault", list(_faults()))
def test_a_broken_path_reads_incorrect(cell, fault):
    with fault():
        result, compared = execute(cell)
    assert not result["correct"], compared
    assert result["failed"] >= 1


def test_no_card_exits_without_a_result():
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                        "3", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                        "5", "--seconds", "2"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_every_seed_draws_the_same_work():
    """The codec's lengths: 16 multiples of the hop from 2 s to 30 s, and two
    seeds send each of them once in every block of 16 requests."""
    from perfbench.drivers import codec

    mix = dict(tiny(CELLS[0])[2], min_seconds=2.0, max_seconds=30.0, n_lengths=16,
               sample_rate=44100)
    sizes = codec.lengths(mix, 512)
    assert len(sizes) == 16 and all(n % 512 == 0 for n in sizes)
    assert abs(sizes[0] - 2 * 44100) <= 512 and abs(sizes[-1] - 30 * 44100) <= 512
    assert np.all(np.diff(sizes) > 0)
    w, config, mix = tiny("dac44k.codec_roundtrip")
    from perfbench.harness.spans import Spans

    orders = []
    for seed in (5, 2**31 + 5):
        state = codec.setup(config, dict(mix, max_requests=64), seed, Spans(False))
        orders.append(state["order"])
        n = len(state["sizes"])
        codec.close(state)
    for order in orders:
        for b in range(0, 64 - n + 1, n):
            assert sorted(order[b: b + n]) == list(range(n))
    assert list(orders[0]) != list(orders[1])
