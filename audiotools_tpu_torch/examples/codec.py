"""Compress / decompress audio files with a (trained) DAC codec.

The serving-side counterpart of ``train_dac``, and of the JAX package's
``examples/codec.py`` flag for flag: load a model folder saved by
``BaseModel.save_to_folder`` (or use random weights with ``--toy`` for a
plumbing check), then

    python -m audiotools_tpu_torch.examples.codec compress in.wav clip.dacz.npz --toy
    python -m audiotools_tpu_torch.examples.codec decompress clip.dacz.npz out.wav --toy

The codec runs on the card; ``--device cpu`` runs it on the host. Artifacts
are compact uint16 code arrays and metadata (``models.artifacts``, the same
files as the JAX package's); pass ``--n-quantizers`` to truncate the
codebook cascade for a lower bitrate.
"""
import argparse

from ..core import AudioSignal, util
from ..models import DAC, compress, decompress, load_artifact, save_artifact
from .train_dac import TOY_DAC


def load_model(args):
    """The model of ``--model`` on ``--device``, or the toy model's seeded
    random weights with ``--toy``."""
    device = args.device or util.default_device()
    if args.model:
        model, _ = DAC.load_from_folder(args.model, device=device)
        return model
    if not args.toy:
        raise SystemExit("pass --model <folder> or --toy")
    return DAC(**TOY_DAC, sample_rate=44100).to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["compress", "decompress"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--model", default=None, help="BaseModel.save_to_folder dir")
    ap.add_argument("--toy", action="store_true", help="random tiny model")
    ap.add_argument("--n-quantizers", type=int, default=None)
    ap.add_argument(
        "--streaming", action="store_true",
        help="encode/decode through fixed-shape overlap-save windows "
        "(identical output, bounded memory; for very long inputs)",
    )
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    return ap.parse_args(argv)


def main(argv=None):
    """Run one compress or decompress; returns the artifact or the signal."""
    args = parse_args(argv)
    model = load_model(args)
    if args.mode == "compress":
        signal = AudioSignal(args.src, device=model.device)
        art = compress(model, signal, n_quantizers=args.n_quantizers, streaming=args.streaming)
        save_artifact(args.dst, art)
        raw = signal.signal_length * signal.num_channels * 2  # 16-bit PCM
        packed = art["codes"].size * 2
        print(f"{args.src} -> {args.dst}: {art['codes'].shape} codes, "
              f"~{raw / packed:.1f}x smaller than 16-bit PCM")
        return art
    recon = decompress(model, load_artifact(args.src), streaming=args.streaming)
    recon.write(args.dst)
    print(f"{args.src} -> {args.dst}: {recon.signal_duration:.2f} s @ {recon.sample_rate} Hz")
    return recon


if __name__ == "__main__":
    main()
