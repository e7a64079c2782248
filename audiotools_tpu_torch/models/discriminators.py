"""Adversarial discriminators for codec training: multi-period (MPD) and
multi-resolution band-spectrogram (MRD) ensembles.

Counterpart of ``audiotools_tpu/models/discriminators.py``, on NCHW
tensors: the JAX package's NHWC images ``(B, H, W, C)`` are ``(B, C, H, W)``
here, with H the time axis (MPD folds, MRD frames) and W the period or the
frequency bins. Every conv is weight-normalized as flax's ``WeightNorm``
normalizes (``scale * v / sqrt(sum v^2 + 1e-12)``, the sum over all but the
output features, ``scale`` starting at ones) and SAME-padded as flax pads
(the low side gets the smaller half). Every sub-discriminator returns its
feature maps, the final logit map last, in fp32.

``dtype`` (e.g. ``torch.bfloat16``) is flax's compute dtype: the weights are
normalized in fp32, then every conv casts its input, weight and bias to
``dtype`` at use; the STFT runs in fp32 and its image is cast before the
first conv. ``stft_method`` is the MRD's analysis, any method of
``ops.fft.stft``: ``"matmul"`` (the default, fp32), ``"fft"``, or
``"matmul_bf16"`` (frames and DFT matrices rounded to bf16, products
summed in fp32).

Under model parallelism (``models.train.shard_params``) a conv's weight may
be sharded on its output channels. The weight norm of a local shard is
exact (each output channel is normalized over its own inputs and taps); the
replicated scale and bias apply per output channel after the gather
(``conv(x, s w) = s conv(x, w)``), so their gradients are whole on every
rank.
"""
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fft as _fft
from ..parallel import tensor as _tp
from .dac import _in_dtype, conv_in_dtype, lecun_normal_

__all__ = [
    "BAND_SPLITS",
    "WNConv2d",
    "PeriodDiscriminator",
    "BandSpectrogramDiscriminator",
    "Discriminator",
]

_LEAK = 0.1

# frequency-band split points (fractions of the rfft bins) of the
# multi-band spectrogram discriminators, as in the published DAC config
BAND_SPLITS: Tuple[Tuple[float, float], ...] = (
    (0.0, 0.1),
    (0.1, 0.25),
    (0.25, 0.5),
    (0.5, 0.75),
    (0.75, 1.0),
)


def _same_pads(n: int, k: int, s: int):
    """flax/lax SAME padding of one axis: ``(low, high)``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class WNConv2d(nn.Module):
    """SAME-padded 2-D conv with flax's weight norm (``weight_norm=False``:
    a plain conv), computing in ``dtype`` when given. ``weight`` is the
    unnormalized kernel ``v`` ``(out, in, kh, kw)``, ``scale`` the
    per-output-feature gain. The weight may be sharded on its output
    channels (module docstring)."""

    _tp_dims = {"weight": 0}

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), weight_norm: bool = True, generator=None,
                 dtype=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = tuple(kernel), tuple(stride), dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *self.kernel))
        lecun_normal_(self.weight, c_in * self.kernel[0] * self.kernel[1], generator)
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.scale = nn.Parameter(torch.ones(c_out)) if weight_norm else None

    def _normalized(self, w):
        if self.scale is None:
            return w
        return w * torch.rsqrt((w * w).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)

    def effective_weight(self):
        w = self._normalized(_tp.local(self.weight))
        return w if self.scale is None else w * _tp.local(self.scale)[:, None, None, None]

    def forward(self, x):
        (h_lo, h_hi), (w_lo, w_hi) = (
            _same_pads(n, k, s) for n, k, s in zip(x.shape[-2:], self.kernel, self.stride))
        if h_lo == h_hi and w_lo == w_hi:
            padding = (h_lo, w_lo)
        else:
            x, padding = F.pad(x, (w_lo, w_hi, h_lo, h_hi)), 0
        group = _tp.shard_group(self.weight, 0)
        bias = _tp.local(self.bias)
        if group is None:
            return conv_in_dtype(F.conv2d, self.dtype, x, self.effective_weight(), bias,
                                 self.stride, padding)
        y = conv_in_dtype(F.conv2d, self.dtype, _tp.copy_to(x, group),
                          self._normalized(_tp.local(self.weight)), None, self.stride, padding)
        y = _tp.gather_from(y, 1, group)
        if self.scale is not None:
            y = y * _tp.local(self.scale).to(y.dtype)[:, None, None]
        return y + bias.to(y.dtype)[:, None, None]


class PeriodDiscriminator(nn.Module):
    """One MPD column: ``(B, T)`` folded into ``(B, 1, T / p, p)`` (the end
    padded by repeating the last sample) and judged by a strided conv stack
    down the time axis, in ``dtype``."""

    def __init__(self, period: int, channels: Sequence[int] = (32, 128, 512, 1024),
                 weight_norm: bool = True, generator=None, dtype=None):
        super().__init__()
        self.period, self.dtype = period, dtype
        layers, c = [], 1
        for ch in channels:
            layers.append(WNConv2d(c, ch, (5, 1), (3, 1), weight_norm, generator, dtype))
            c = ch
        layers.append(WNConv2d(c, channels[-1], (5, 1), weight_norm=weight_norm,
                               generator=generator, dtype=dtype))
        self.layers = nn.ModuleList(layers)
        self.logits = WNConv2d(channels[-1], 1, (3, 1), weight_norm=weight_norm,
                               generator=generator, dtype=dtype)

    def forward(self, x):
        B, T = x.shape
        p = self.period
        pad = (-T) % p
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="replicate")[:, 0]
        (h,) = _in_dtype(self.dtype, x.reshape(B, 1, -1, p))
        feats = []
        for layer in self.layers:
            h = F.leaky_relu(layer(h), _LEAK)
            feats.append(h)
        feats.append(self.logits(h))
        return [f.float() for f in feats]


class BandSpectrogramDiscriminator(nn.Module):
    """One MRD column: the complex STFT at ``window_length`` (hop a quarter)
    as a ``(B, 2, frames, bins)`` re/im image, cut into frequency bands, each
    judged by its own conv stack; the bands' last maps are joined along the
    frequency axis for the logit map. The convs compute in ``dtype``."""

    def __init__(self, window_length: int, channels: int = 32,
                 bands: Tuple[Tuple[float, float], ...] = BAND_SPLITS,
                 stft_method: str = "matmul", weight_norm: bool = True, generator=None,
                 dtype=None):
        super().__init__()
        self.window_length, self.bands, self.stft_method = window_length, tuple(bands), stft_method
        self.dtype = dtype

        def stack():
            convs = [WNConv2d(2 if i == 0 else channels, channels, (3, 9),
                              (1, 2) if i else (1, 1), weight_norm, generator, dtype)
                     for i in range(4)]
            convs.append(WNConv2d(channels, channels, (3, 3), weight_norm=weight_norm,
                                  generator=generator, dtype=dtype))
            return nn.ModuleList(convs)

        self.band_convs = nn.ModuleList([stack() for _ in self.bands])
        self.logits = WNConv2d(channels, 1, (3, 3), weight_norm=weight_norm, generator=generator,
                               dtype=dtype)

    def forward(self, x):
        spec = _fft.stft(x, self.window_length, self.window_length // 4, "hann",
                         method=self.stft_method).transpose(-1, -2)  # (B, frames, bins)
        (img,) = _in_dtype(self.dtype, torch.stack([spec.real, spec.imag], dim=1))
        n_bins = img.shape[-1]
        edges = [int(round(f * n_bins)) for f, _ in self.bands] + [n_bins]
        feats, outs = [], []
        for b, convs in enumerate(self.band_convs):
            h = img[..., edges[b]: edges[b + 1]]
            for conv in convs:
                h = F.leaky_relu(conv(h), _LEAK)
                feats.append(h)
            outs.append(h)
        feats.append(self.logits(torch.cat(outs, dim=-1)))
        return [f.float() for f in feats]


class Discriminator(nn.Module):
    """The DAC discriminator ensemble: MPD at prime periods and MRD at three
    STFT resolutions. Takes ``(B, 1, T)`` or ``(B, T)`` audio and returns one
    feature-map list per sub-discriminator (MPD first), logits last in
    each, all fp32. ``seed`` seeds the initialization; ``dtype`` is the
    convs' compute dtype (module docstring)."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 fft_sizes: Tuple[int, ...] = (2048, 1024, 512),
                 mpd_channels: Sequence[int] = (32, 128, 512, 1024), mrd_channels: int = 32,
                 bands: Tuple[Tuple[float, float], ...] = BAND_SPLITS,
                 stft_method: str = "matmul", weight_norm: bool = True, seed: int = 0,
                 dtype: torch.dtype = None):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        self.mpd = nn.ModuleList([
            PeriodDiscriminator(p, tuple(mpd_channels), weight_norm, generator, dtype)
            for p in periods])
        self.mrd = nn.ModuleList([
            BandSpectrogramDiscriminator(n, mrd_channels, tuple(bands), stft_method,
                                         weight_norm, generator, dtype) for n in fft_sizes])

    def forward(self, audio):
        x = (audio[:, 0, :] if audio.ndim == 3 else audio).float()
        return [d(x) for d in self.mpd] + [d(x) for d in self.mrd]
