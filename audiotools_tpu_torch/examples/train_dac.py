"""End-to-end DAC codec training: the canonical usage of the whole port.

CSV manifest -> AudioDataset over host AudioLoader workers -> DataLoader
staging each batch to the card -> augmentation on the card -> the DAC
reconstruction step, or the adversarial step against the MPD + MRD
ensemble -> Tracker metrics -> ``torch.save`` checkpoints with mid-epoch
resume (models, optimizers, tracker and the data position). Counterpart of
the JAX package's ``examples/train_dac.py``, step for step and flag for
flag; ``--device cpu`` runs it on the host.

A smoke pass (writes its own speech-like fixtures):

    python -m audiotools_tpu_torch.examples.train_dac --steps 4 --batch-size 4 --toy
    python -m audiotools_tpu_torch.examples.train_dac --steps 4 --batch-size 4 --toy \\
        --device cpu

or real data:

    PATH_TO_DATA=/data python -m audiotools_tpu_torch.examples.train_dac \\
        --sources train.csv --steps 10000 --batch-size 16 --adversarial

Run again with the same ``--ckpt-dir`` to resume from its latest step.
"""
import argparse
import contextlib
import csv
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .. import ml
from ..data import transforms as tfm
from ..data.datasets import AudioDataset, AudioLoader
from ..io import write_wav
from ..ml.checkpoint import Checkpointer
from ..ml.decorators import Tracker, timer
from ..models import DAC, Discriminator
from ..models.adversarial import make_adversarial_train_step
from ..models.train import make_train_step

FIXTURE_SR = 44100

# the toy widths of the JAX example
TOY_DAC = dict(encoder_dim=16, encoder_rates=(2, 4, 4, 4), latent_dim=32, decoder_dim=128,
               n_codebooks=4, codebook_size=64, codebook_dim=4)
TOY_DISC = dict(periods=(2, 3, 5), fft_sizes=(512, 256), mpd_channels=(8, 16), mrd_channels=8)


def speech_like(seed: int, duration: float = 12.0, sr: int = FIXTURE_SR) -> np.ndarray:
    """A seeded speech-like clip: a gliding harmonic buzz, amplitude-modulated,
    with noise."""
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    t = np.arange(n) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.4 * t + rng.rand() * 6)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    sig = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25), (5, 0.12)]:
        sig += a * np.sin(h * phase + rng.rand() * 6)
    noise = rng.randn(n) * 0.15
    am = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t + rng.rand() * 6))
    am = am * (rng.rand(n) < 0.999)
    return ((sig * am + noise * am) * 0.15).astype(np.float32)


def write_fixtures(root) -> str:
    """Three seeded 12 s speech-like WAVs at 44.1 kHz under ``root/spk/``
    and their manifest; returns the manifest's path."""
    root = Path(root)
    (root / "spk").mkdir(parents=True, exist_ok=True)
    manifest = root / "spk.csv"
    with open(manifest, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["path"])
        writer.writeheader()
        for i in range(3):
            path = root / "spk" / f"spk_{i}.wav"
            write_wav(path, speech_like(i)[None, :], FIXTURE_SR)
            writer.writerow({"path": str(path)})
    return str(manifest)


def make_dataset(args, sources):
    """The loop's dataset: ``args.steps * args.batch_size`` excerpts of
    ``args.duration`` seconds, with the augmentation drawn on the host."""
    transform = tfm.Compose(
        tfm.VolumeNorm(("uniform", -20, -14)),
        tfm.LowPass(prob=0.3),
        tfm.ClippingDistortion(prob=0.1),
        name="augment",
    )
    return AudioDataset(
        AudioLoader(sources=sources),
        sample_rate=args.sample_rate,
        n_examples=args.steps * args.batch_size,
        duration=args.duration,
        transform=transform,
    )


def adamw(module, lr):
    """``optax.adamw(lr)`` of the JAX example (torch's default weight decay
    is 1e-2, optax's 1e-4)."""
    return torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def build(args):
    """The run's accelerator, tracker, models, optimizers and step function,
    as ``SimpleNamespace(accel, tracker, model, params, opt_state, step_fn,
    T)``: ``params`` and ``opt_state`` are the modules and optimizers the
    checkpoint holds (``{"g": ..., "d": ...}`` when adversarial)."""
    accel = ml.Accelerator(amp=args.amp, device=args.device)
    tracker = Tracker(rank=accel.local_rank)
    dtype = torch.bfloat16 if args.amp else None

    # the JAX example's full-width model runs formulation="hybrid", whose
    # checkpoints interchange with the conv formulation the port has
    model = DAC(**(TOY_DAC if args.toy else {}), sample_rate=args.sample_rate, dtype=dtype,
                seed=args.seed)
    # length must be a multiple of the model hop
    T = int(args.duration * args.sample_rate)
    T = (T // model.hop_length) * model.hop_length

    gen = accel.prepare_model(model)
    opt = adamw(model, args.lr)
    if args.adversarial:
        # the full DAC recipe: LSGAN + feature matching against the
        # MPD + multi-band spectrogram discriminator ensemble
        disc = Discriminator(**(TOY_DISC if args.toy else {}), dtype=dtype, seed=args.seed + 1)
        d_net = accel.prepare_model(disc)
        d_opt = adamw(disc, args.lr)
        # both nets resume together from the same step
        params, opt_state = {"g": model, "d": disc}, {"g": opt, "d": d_opt}
        step_fn = make_adversarial_train_step(gen, d_net, opt, d_opt, args.sample_rate)
    else:
        params, opt_state = model, opt
        step_fn = make_train_step(gen, opt, args.sample_rate)
    return SimpleNamespace(accel=accel, tracker=tracker, model=model, params=params,
                           opt_state=opt_state, step_fn=step_fn, T=T)


def main(args):
    """Train for ``args.steps`` steps, resuming from the latest checkpoint
    under ``args.ckpt_dir``; returns the run (``build``'s namespace, with
    the ``Checkpointer`` as ``ckpt``)."""
    run = build(args)
    accel, tracker, T = run.accel, run.tracker, run.T
    run.ckpt = ckpt = Checkpointer(args.ckpt_dir, max_to_keep=3)

    # mid-epoch resume: restore models, optimizers and tracker, and skip
    # the indices already seen
    start_idx = 0
    if ckpt.latest_step() is not None:
        _, meta = ckpt.restore(template={"params": run.params, "opt_state": run.opt_state})
        if meta.get("tracker"):
            tracker.load_state_dict(meta["tracker"])
        start_idx = meta.get("data_idx") or 0
        tracker.print(f"resumed from step {tracker.step} (data idx {start_idx})")

    def save():
        if accel.local_rank == 0:
            # data_idx counts the global samples seen (tracker.step survives
            # a resume; a local loop counter would roll the resume point back)
            ckpt.save(tracker.step, run.params, run.opt_state, tracker=tracker,
                      data_idx=tracker.step * args.batch_size)

    with contextlib.ExitStack() as stack:
        sources = args.sources
        if not sources:
            root = stack.enter_context(tempfile.TemporaryDirectory())
            sources = [write_fixtures(root)]
        dataset = make_dataset(args, sources)
        dl = accel.prepare_dataloader(dataset, start_idx=start_idx,
                                      batch_size=args.batch_size, num_workers=args.num_workers)

        @tracker.log("train", "value")
        @tracker.track("train", args.steps, completed=tracker.step)
        @timer()
        def train_step(batch):
            sig = dataset.transform(batch["signal"], **batch["transform_args"])
            audio = accel.prepare_batch(sig.audio_data[..., :T])
            return run.step_fn(audio)

        with tracker.live:
            for batch in dl:
                if tracker.step >= args.steps:
                    break
                tracker.step += 1
                train_step(batch)
                if tracker.step % args.ckpt_every == 0:
                    save()
            tracker.done("train", f"finished at step {tracker.step}")

    if ckpt.latest_step() != tracker.step:
        save()
    return run


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sources", nargs="*", default=None, help="CSV manifests")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--duration", type=float, default=0.38)
    p.add_argument("--sample-rate", type=int, default=44100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--amp", action="store_true", help="bfloat16 compute")
    p.add_argument(
        "--adversarial", action="store_true",
        help="train against the MPD+MRD discriminator ensemble "
        "(LSGAN + feature matching, the published DAC recipe)",
    )
    p.add_argument("--toy", action="store_true", help="tiny model for smoke runs")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--ckpt-dir", default="runs/dac_ckpt")
    p.add_argument("--device", default=None,
                   help="compute device (default: the card; 'cpu' for the host)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
