"""Driver of the augmentation chain: ``AudioDataset`` -> ``Compose(
RoomImpulseResponse, BackgroundNoise, Equalizer, VolumeNorm)`` ->
``pitch_shift`` -> ``mel_spectrogram`` -> ``loudness``, as ``bench.py`` and
``chip_smoke.py`` run it.

Set-up writes a fixture tree of seeded WAV files under a fresh directory of
``TMPDIR``, draws ``pool`` batches of distinct dataset indices from the seed,
and stages them on the card through the program's ``DataLoader``; each
item's transform arguments are drawn by the dataset. It warms the chain on
every batch of the pool. The window is a closed loop over the pool with at
most ``in_flight`` batches dispatched ahead; a batch completes when its
last kernel does. ``check`` compares, for batches the window produced, each
stage's output with the plain reference (``perfbench/reference/chain.py``)
computed from the same staged inputs and drawn arguments, stage by stage
from the program's previous stage.
"""
import shutil
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from perfbench.harness import device as dev
from perfbench.harness.spans import wrap_entry_points
from perfbench.reference import chain as ref
from perfbench.traffic.clips import sub_seeds, write_fixture_tree

KERNELS = ("fir_causal_batch", "phase_vocoder_fused", "fir_causal", "istft_synthesis_fused")


def _meter(mix):
    return {"kind": "fir", "zeros": mix["meter_zeros"]} if mix["meter"] == "fir" else {
        "kind": "exact"}


def build_dataset(root, config, mix, n_examples):
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    lists = write_fixture_tree(root, mix["corpora"], mix["corpus_seed"], config["sample_rate"])
    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(lists["ir"])]),
        tfm.BackgroundNoise(sources=[str(lists["noise"])]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    return AudioDataset(AudioLoader(sources=[str(lists["speech"])]),
                        sample_rate=config["sample_rate"], n_examples=n_examples,
                        duration=config["clip_seconds"], transform=transform)


def run_chain(state, batch, spans):
    """One batch through the chain; returns its four stage outputs."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import stretch as PS

    sr, mix = state["sr"], state["mix"]
    with spans.span("transforms"):
        out = state["ds"].transform(batch["signal"].clone(), **batch["transform_args"])
    with spans.span("pitch_shift"):
        audio = PS.pitch_shift(out.audio_data, mix["semitones"], sr,
                               synthesis_method=mix["synthesis_method"],
                               pv_formulation="phasor_fused")
    with spans.span("features"):
        mel = PF.mel_spectrogram(audio, sr, mix["n_mels"], method="matmul")
        lufs = PL.loudness(audio, sr)
    return out.audio_data, audio, mel, lufs


def setup(config, mix, seed, spans):
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL

    PL.set_fast_meter(mix["meter"] == "fir", zeros=mix.get("meter_zeros", 512))
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="perfbench-chain-"))
    batch, pool = config["batch"], mix["pool"]
    # distinct dataset indices drawn from the seed: each item's clips and
    # transform arguments follow from its index
    rng = np.random.default_rng(int(seed))
    indices = [int(i) for i in rng.choice(2**31 - 1, size=batch * pool, replace=False)]
    ds = build_dataset(root, config, {**mix, "corpus_seed": sub_seeds(seed, 1)[0]},
                       n_examples=max(indices) + 1)
    loader = DataLoader(ds, batch_size=batch, num_workers=mix["loader_workers"],
                        sampler=indices, device=dev.device())
    t1 = time.perf_counter()
    batches = list(loader)
    t2 = time.perf_counter()
    state = dict(root=root, ds=ds, pool=batches, sr=config["sample_rate"], mix=mix,
                 config=config, seed=seed, restore=None)
    if spans.traced:
        state["restore"] = wrap_entry_points(HK, KERNELS, spans)
    for b in batches:  # every shape the window uses
        run_chain(state, b, spans.__class__(traced=False))
    dev.synchronize()
    t3 = time.perf_counter()
    print(f"perfbench: set-up: fixtures {t1 - t0:.2f} s, {pool} batches through the loader "
          f"{t2 - t1:.2f} s, warm-up {t3 - t2:.2f} s", file=sys.stderr)
    spans.records.clear()
    spans.calls.clear()
    rs = np.random.RandomState(sub_seeds(seed, 1, salt=7)[0])
    state["judged"] = sorted(rs.choice(pool, size=min(mix["judged_batches"], pool),
                                       replace=False).tolist())
    return state


def window(state, seconds, spans):
    """The closed loop: batch ``i`` of the window is pool batch ``i mod
    pool``; at most ``in_flight`` batches are queued on the device. The
    window ends when the loop stops issuing and the last batch completes."""
    pool, mix = state["pool"], state["mix"]
    limit = mix["trace_iterations"] if spans.traced else None
    queued, kept = deque(), {}
    dev.synchronize()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds and (limit is None or i < limit):
        if len(queued) >= mix["in_flight"]:
            queued.popleft().synchronize()
        with spans.span("batch"):
            outputs = run_chain(state, pool[i % len(pool)], spans)
        queued.append(dev.event())
        if i % len(pool) in state["judged"]:
            kept[i % len(pool)] = (i, outputs)
        i += 1
    dev.synchronize()
    elapsed = time.perf_counter() - start
    state["kept"] = kept
    clips = i * state["config"]["batch"]
    return {"attempted": i, "failed": 0, "iterations": i,
            "metrics": {mix["rate_metric"]: clips / elapsed}}


def staged_inputs(batch):
    """The staged batch's audio and drawn arguments as float64 tensors."""
    args = batch["transform_args"]
    args = args.get("Compose", args)
    rir, bg = args["0.RoomImpulseResponse"], args["1.BackgroundNoise"]

    def f64(t):
        return torch.as_tensor(t).to(torch.float64)

    return batch["signal"].audio_data.to(torch.float64), {
        "ir": rir["ir_signal"].audio_data.to(torch.float64), "ir_eq": f64(rir["eq"]),
        "drr": f64(rir["drr"]), "noise": bg["bg_signal"].audio_data.to(torch.float64),
        "noise_eq": f64(bg["eq"]), "snr": f64(bg["snr"]),
        "eq": f64(args["2.Equalizer"]["eq"]), "db": f64(args["3.VolumeNorm"]["db"]),
    }


def _rel(got, want):
    got = got.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def judge(batch, outputs, sr, mix, q=ref.identity, q_synthesis=ref.identity):
    """The four numbers of one batch: the largest gap of each stage's output
    against the reference's, relative to the reference's largest magnitude
    (LUFS: in dB). The reference runs each stage from the program's previous
    stage, the transforms from the staged inputs."""
    transformed, audio, mel, lufs = outputs
    meter = _meter(mix)
    with torch.no_grad():
        x, args = staged_inputs(batch)
        want = ref.transforms(x, args, sr, meter, q)
        numbers = {"transforms_rel": _rel(transformed, want)}
        del want
        want = ref.pitch_shift(transformed.to(torch.float64), mix["semitones"], sr, q, q_synthesis)
        numbers["pitch_rel"] = _rel(audio, want)
        del want
        a64 = audio.to(torch.float64)
        numbers["mel_rel"] = _rel(mel, ref.mel_spectrogram(a64, sr, mix["n_mels"], q=q))
        numbers["lufs_db"] = float((lufs.to(torch.float64) - ref.loudness(a64, sr, meter, q))
                                   .abs().max())
    return numbers


def control_outputs(batch, sr, mix, q, q_synthesis):
    """The reference in the program's place, each operand rounded by ``q``
    (``q_synthesis`` for the synthesis): its four stage outputs, each stage
    from its own previous one."""
    with torch.no_grad():
        x, args = staged_inputs(batch)
        transformed = ref.transforms(x, args, sr, _meter(mix), q)
        audio = ref.pitch_shift(transformed, mix["semitones"], sr, q, q_synthesis)
        mel = ref.mel_spectrogram(audio, sr, mix["n_mels"], q=q)
        return transformed, audio, mel, ref.loudness(audio, sr, _meter(mix), q)


def control(state):
    """The control's numbers: the reference computed a precision below the
    configuration's (bf16 for its fp32, fp8 for its bf16 synthesis) in the
    program's place, judged as the program is."""
    q, q_syn = ref.rounding(torch.bfloat16), ref.rounding(torch.float8_e4m3fn)
    worst = {}
    for p in sorted(state["kept"]):
        batch = state["pool"][p]
        outputs = control_outputs(batch, state["sr"], state["mix"], q, q_syn)
        for name, v in judge(batch, outputs, state["sr"], state["mix"]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def check(state, window):
    """Each number's worst over the judged batches, with its limit. Runs
    after the window with the program's caches freed; TF32 is off for the
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev.empty_cache()
    worst = {}
    for p, (_, outputs) in sorted(state["kept"].items()):
        for name, v in judge(state["pool"][p], outputs, state["sr"], state["mix"]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    limits = state["mix"]["limits"]
    if not state["kept"]:
        return [(name, float("inf"), limit) for name, limit in limits.items()]
    return [(name, worst[name], limits[name]) for name in limits]


def close(state):
    from audiotools_tpu_torch.ops import loudness as PL

    if state.get("restore"):
        state["restore"]()
    PL.set_fast_meter(False)
    shutil.rmtree(state["root"], ignore_errors=True)
