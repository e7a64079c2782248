"""The benchmark's own analytic model FLOPs of the DAC codec and its
discriminators, at any widths.

Frozen copies of the port's ``ops/perf.py`` counters (``dac_generator_macs``,
``mpd_macs``, ``mrd_macs``) at the time the benchmark was defined; the
adversarial step's count takes the widths (``ops.perf.
adversarial_train_step_flops`` always counts the default model). Every
conv, transposed conv, dense layer and codebook similarity is counted;
activations, norms and the argmax are elementwise work and left out (the
usual model-FLOP convention). 2 FLOPs a MAC.
"""
import math


def _conv_macs(t_out, cin, cout, k):
    return t_out * cin * cout * k


def generator_macs(T, encoder_dim=64, encoder_rates=(2, 4, 8, 8), latent_dim=256,
                   decoder_dim=1024, n_codebooks=9, codebook_size=1024, codebook_dim=8,
                   **_):
    """Per-item forward MACs of the DAC generator on ``T`` samples (a
    multiple of the hop), by section."""
    sections = {"encoder": 0, "rvq": 0, "decoder": 0}
    t, d = T, encoder_dim
    sections["encoder"] += _conv_macs(t, 1, d, 7)
    for stride in encoder_rates:
        for _dilation in (1, 3, 9):
            sections["encoder"] += _conv_macs(t, d, d, 7) + _conv_macs(t, d, d, 1)
        t //= stride
        sections["encoder"] += _conv_macs(t, d, 2 * d, 2 * stride)
        d *= 2
    sections["encoder"] += _conv_macs(t, d, latent_dim, 3)
    for _ in range(n_codebooks):
        sections["rvq"] += t * (latent_dim * codebook_dim + codebook_dim * codebook_size
                                + codebook_dim * latent_dim)
    d = decoder_dim
    sections["decoder"] += _conv_macs(t, latent_dim, d, 7)
    for stride in reversed(encoder_rates):
        sections["decoder"] += t * d * (d // 2) * 2 * stride  # transposed conv
        t *= stride
        d //= 2
        for _dilation in (1, 3, 9):
            sections["decoder"] += _conv_macs(t, d, d, 7) + _conv_macs(t, d, d, 1)
    sections["decoder"] += _conv_macs(t, d, 1, 7)
    return sections


def mpd_macs(T, periods=(2, 3, 5, 7, 11), channels=(32, 128, 512, 1024)):
    """Per-item forward MACs of the multi-period discriminator."""
    total = 0
    for p in periods:
        t = -(-T // p)
        cin = 1
        for ch in channels:
            t = -(-t // 3)
            total += t * p * cin * ch * 5
            cin = ch
        total += t * p * cin * cin * 5 + t * p * cin * 3
    return total


def mrd_macs(T, fft_sizes=(2048, 1024, 512), channels=32):
    """Per-item forward MACs of the multi-resolution band discriminator (the
    STFT at 5 N log2 N a transform; the bands' summed widths taken as F, F/2,
    F/4, F/8 at each conv level)."""
    total = 0
    for n in fft_sizes:
        frames = T // (n // 4) + 1
        f_bins = n // 2 + 1
        total += int(frames * 5 * n * math.log2(n)) // 2
        total += frames * f_bins * 2 * channels * 27
        for level in (1, 2, 3):
            total += frames * (f_bins >> level) * channels * channels * 27
        total += frames * (f_bins >> 3) * channels * channels * 9
        total += frames * (f_bins >> 3) * channels * 9
    return total


def adversarial_step_flops(batch, T, widths, periods=(2, 3, 5, 7, 11),
                           fft_sizes=(2048, 1024, 512)):
    """FLOPs of one two-optimizer step at ``widths`` (the DAC constructor's
    keys): the generator forward and backward (3x forward), the
    discriminators' D(fake) and D(real) forwards with D(fake)'s input
    gradient in the generator's update (~3x forward) and D(real) + D(fake)
    forward and backward in their own (~6x forward)."""
    g = sum(generator_macs(T, **widths).values())
    d = mpd_macs(T, periods) + mrd_macs(T, fft_sizes)
    return 2 * batch * (3 * g + 9 * d)


def codec_roundtrip_flops(T, widths):
    """FLOPs of compressing and decompressing one clip of ``T`` samples:
    the encoder and quantizer forward, then the codes' lookup and the
    decoder forward (the quantizer's similarity is not run on decode)."""
    hop = 1
    for r in widths.get("encoder_rates", (2, 4, 8, 8)):
        hop *= r
    t = -(-T // hop) * hop
    s = generator_macs(t, **widths)
    t_codes = t // hop
    lookup = widths.get("n_codebooks", 9) * t_codes * widths.get("codebook_dim", 8) * widths.get(
        "latent_dim", 256)
    return 2 * (s["encoder"] + s["rvq"] + lookup + s["decoder"])
