"""DAC-style neural audio codec: a convolutional encoder and decoder with
Snake activations around a residual vector quantizer.

Counterpart of ``audiotools_tpu/models/dac.py``, as ``nn.Module``s on
``(B, C, T)`` tensors. The fields and defaults are the JAX constructor's;
the parameters are initialized as flax initializes them (``lecun_normal``
kernels, zero biases, the residual units' near-identity output conv,
unit-normal codebooks, Snake ``alpha`` of ones) from an explicit
generator seeded by ``seed``, or carried over from a JAX parameter tree by
``models.convert``. A model computes on the device of its parameters. The
convolutions run at the caller's TF32 settings; the codebook similarity
runs in full fp32, as the JAX package pins it at ``HIGHEST``.

``dtype`` is flax's compute dtype: the parameters stay fp32, and every conv
and transposed conv of the encoder and decoder casts its input, weight and
bias to ``dtype`` where it uses them (explicit casts, not autocast, so the
model computes what the JAX package computes); Snake runs in its input's
dtype, through kernel G for fp32 on the card (``snake``). The encoder
hands fp32 latents to the quantizer and the decoder returns an fp32
waveform.

``DAC(formulation=...)`` takes the JAX package's names (``"conv"``,
``"hybrid"``, ``"matmul"``) and computes every one as convs. The JAX
package's ``hybrid`` and ``matmul`` write the residual units' convs as
shifted matmuls over the same parameters, the same function lowered
another way for XLA on a TPU. On an H100 that lowering is slower than
cuDNN's convs and takes more memory (``PERF.md``), so the port keeps one
path. A checkpoint of any JAX formulation loads (``models.convert``), and
``save``/``load`` keep the name.

Under model parallelism (``models.train.shard_params``) the parameters are
``DTensor``s. Every layer computes on their local tensors; a conv,
transposed conv or dense layer whose weight is sharded on its output
channels computes its own channels and gathers them over the tensor axis
(``parallel.tensor``), then adds its replicated bias.
"""
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._hostprof import span
from ..ml.layers.base import BaseModel
from ..ops import hopper_kernels as HK
from ..ops._fp32 import strict_fp32
from ..parallel import tensor as _tp

FORMULATIONS = ("conv", "hybrid", "matmul")

__all__ = [
    "snake",
    "Conv1d",
    "Snake",
    "ResidualUnit",
    "EncoderBlock",
    "ConvTranspose1dSame",
    "DecoderBlock",
    "Encoder",
    "Decoder",
    "VectorQuantize",
    "ResidualVectorQuantize",
    "DAC",
]


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation ``x + sin^2(alpha x) / alpha``. An fp32 input on the
    card runs kernel G (``hopper_kernels.snake``: one pass forward, one
    backward, saving only ``x`` and ``alpha``), bit for bit the expression;
    every other dtype or device runs the expression itself, so a bf16 model
    rounds after each operation as before."""
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return HK.snake(x, alpha)
    return HK.snake_plain(x, alpha)


class Snake(nn.Module):
    """Snake with one ``alpha`` a channel, ``(1, C, 1)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x):
        return snake(x, _tp.local(self.alpha).to(x.dtype))


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated at two deviations, with
    the deviation corrected so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _in_dtype(dtype, *tensors):
    """``tensors`` cast to the compute ``dtype`` (as they are for None; a
    None among them stays None)."""
    return tensors if dtype is None else tuple(t if t is None else t.to(dtype) for t in tensors)


def conv_in_dtype(conv, dtype, x, weight, bias, *args):
    """``conv(x, weight, bias, *args)`` with its operands cast to the compute
    ``dtype``. On the card that is cuDNN's conv in ``dtype`` (products summed
    in fp32, the sum rounded to ``dtype``). The CPU's bf16 convolutions miss
    by O(1) at some shapes (a 9-tap 2-D conv to a width-1 output), so on the
    host the rounded operands are summed in fp32 and the sum rounded to
    ``dtype``: the same arithmetic."""
    if dtype is None:
        return conv(x, weight, bias, *args)
    x, weight, bias = _in_dtype(dtype, x, weight, bias)
    if x.device.type == "cpu":
        bias = bias if bias is None else bias.float()
        return conv(x.float(), weight.float(), bias, *args).to(dtype)
    return conv(x, weight, bias, *args)


def column_parallel(conv, x, weight, bias, out_dim, *args, dtype=None, channel_dim=1):
    """``conv(x, weight, bias, *args)`` in ``dtype`` (``conv_in_dtype``) on
    the local tensors of ``weight`` and ``bias``. When ``weight`` is sharded
    on its output channels (its ``out_dim``), each rank computes its own
    channels, the output's ``channel_dim`` is gathered over the shards'
    process group, and the whole bias is added after the gather, so its
    gradient is whole on every rank."""
    group = _tp.shard_group(weight, out_dim)
    weight, bias = _tp.local(weight), _tp.local(bias)
    if group is None:
        return conv_in_dtype(conv, dtype, x, weight, bias, *args)
    y = conv_in_dtype(conv, dtype, _tp.copy_to(x, group), weight, None, *args)
    y = _tp.gather_from(y, channel_dim, group)
    return y + bias.to(y.dtype).reshape(-1, *([1] * (y.ndim - 1 - channel_dim % y.ndim)))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` when it is given: input,
    weight and bias cast at use, the parameters kept as they are. Its weight
    may be sharded on its output channels (``column_parallel``)."""

    _tp_dims = {"weight": 0}

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return column_parallel(self._conv_forward, x, self.weight, self.bias, 0,
                               dtype=self.compute_dtype)


def _conv1d(c_in, c_out, k, generator, dilation=1, stride=1, padding=None, std=None,
            dtype=None):
    """A flax-initialized ``Conv1d`` computing in ``dtype``; ``padding``
    defaults to SAME for an odd kernel at stride 1, ``std`` replaces
    ``lecun_normal`` by a plain normal of that deviation."""
    if padding is None:
        padding = dilation * (k - 1) // 2
    conv = Conv1d(c_in, c_out, k, stride=stride, padding=padding, dilation=dilation,
                  compute_dtype=dtype)
    if std is None:
        lecun_normal_(conv.weight, k * c_in, generator)
    else:
        with torch.no_grad():
            conv.weight.normal_(0.0, std, generator=generator)
    nn.init.zeros_(conv.bias)
    return conv


class ResidualUnit(nn.Module):
    """Snake -> dilated conv(7) -> Snake -> conv(1), added to the input. The
    output conv starts near zero (normal, deviation 1e-2), so the unit
    starts near the identity."""

    def __init__(self, dim: int, dilation: int = 1, generator=None, dtype=None):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = _conv1d(dim, dim, 7, generator, dilation=dilation, dtype=dtype)
        self.snake2 = Snake(dim)
        self.conv2 = _conv1d(dim, dim, 1, generator, std=1e-2, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    """Three residual units at ``dim // 2`` (dilations 1, 3, 9), Snake, and a
    conv of ``2 stride`` taps at ``stride`` to ``dim`` channels."""

    def __init__(self, dim: int, stride: int, generator=None, dtype=None):
        super().__init__()
        self.units = nn.ModuleList([ResidualUnit(dim // 2, d, generator, dtype)
                                    for d in (1, 3, 9)])
        self.snake = Snake(dim // 2)
        self.conv = _conv1d(dim // 2, dim, 2 * stride, generator, stride=stride,
                            padding=math.ceil(stride / 2), dtype=dtype)

    def forward(self, x):
        for unit in self.units:
            x = unit(x)
        return self.conv(self.snake(x))


class ConvTranspose1dSame(nn.ConvTranspose1d):
    """flax's ``ConvTranspose`` with ``padding="SAME"``, on the tap-flipped
    kernel: lax pads the stride-dilated input by ``pad_a = ceil((k + s -
    2) / 2)`` on the left (``k - 1`` when ``s > k - 1``) and ``k + s - 2 -
    pad_a`` on the right, which is the full transposed conv cropped by ``k
    - 1`` less each. ``ConvTranspose1d`` crops ``padding`` at both ends, so
    where the two crops differ (an odd stride at ``k = 2 s``) the right one
    is finished here. The output is ``stride`` times the input. With
    ``compute_dtype`` set, input, weight and bias are cast to it at use. Its
    weight ``(in, out, k)`` may be sharded on its output channels, dim 1
    (``column_parallel``)."""

    _tp_dims = {"weight": 1}

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 compute_dtype=None):
        pad_len = kernel_size + stride - 2
        pad_a = kernel_size - 1 if stride > kernel_size - 1 else math.ceil(pad_len / 2)
        left, right = kernel_size - 1 - pad_a, kernel_size - 1 - (pad_len - pad_a)
        super().__init__(c_in, c_out, kernel_size, stride=stride, padding=min(left, right))
        self.crops = (left - min(left, right), right - min(left, right))
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = column_parallel(F.conv_transpose1d, x, self.weight, self.bias, 1, self.stride,
                            self.padding, self.output_padding, self.groups, self.dilation,
                            dtype=self.compute_dtype)
        left, right = self.crops
        return y[..., left: y.shape[-1] - right] if left or right else y


class DecoderBlock(nn.Module):
    """Snake, a transposed conv of ``2 stride`` taps up by ``stride`` to
    ``dim`` channels, and three residual units (dilations 1, 3, 9)."""

    def __init__(self, in_dim: int, dim: int, stride: int, generator=None, dtype=None):
        super().__init__()
        k = 2 * stride
        self.snake = Snake(in_dim)
        self.conv = ConvTranspose1dSame(in_dim, dim, k, stride, dtype)
        # flax's fan-in of a (k, in, out) kernel: k * in
        lecun_normal_(self.conv.weight, k * in_dim, generator)
        nn.init.zeros_(self.conv.bias)
        self.units = nn.ModuleList([ResidualUnit(dim, d, generator, dtype) for d in (1, 3, 9)])

    def forward(self, x):
        x = self.conv(self.snake(x))
        for unit in self.units:
            x = unit(x)
        return x


class Encoder(nn.Module):
    """``(B, 1, T)`` -> fp32 ``(B, latent_dim, T / prod(strides))``, computed
    in ``dtype``."""

    def __init__(self, d_model: int = 64, strides=(2, 4, 8, 8), latent_dim: int = 256,
                 generator=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_in = _conv1d(1, d_model, 7, generator, dtype=dtype)
        blocks, d = [], d_model
        for stride in strides:
            blocks.append(EncoderBlock(2 * d, stride, generator, dtype))
            d *= 2
        self.blocks = nn.ModuleList(blocks)
        self.snake = Snake(d)
        self.conv_out = _conv1d(d, latent_dim, 3, generator, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(*_in_dtype(self.dtype, x))
        for block in self.blocks:
            x = block(x)
        # latents return to fp32 for the quantizer's codebook math
        return self.conv_out(self.snake(x)).float()


class Decoder(nn.Module):
    """``(B, latent_dim, T')`` -> fp32 ``(B, 1, T' prod(strides))`` in (-1,
    1), computed in ``dtype``."""

    def __init__(self, latent_dim: int = 256, d_model: int = 1024, strides=(8, 8, 4, 2),
                 generator=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_in = _conv1d(latent_dim, d_model, 7, generator, dtype=dtype)
        blocks, d = [], d_model
        for stride in strides:
            blocks.append(DecoderBlock(d, d // 2, stride, generator, dtype))
            d //= 2
        self.blocks = nn.ModuleList(blocks)
        self.snake = Snake(d)
        self.conv_out = _conv1d(d, 1, 7, generator, dtype=dtype)

    def forward(self, z):
        x = self.conv_in(*_in_dtype(self.dtype, z))
        for block in self.blocks:
            x = block(x)
        # the waveform returns to fp32 for the loss stack
        return torch.tanh(self.conv_out(self.snake(x))).float()


class _Linear(nn.Linear):
    """``nn.Linear`` whose weight may be sharded on its output features,
    gathered along the last dim (``column_parallel``)."""

    _tp_dims = {"weight": 0}

    def forward(self, x):
        return column_parallel(F.linear, x, self.weight, self.bias, 0, channel_dim=-1)


def _linear(c_in, c_out, generator):
    layer = _Linear(c_in, c_out)
    lecun_normal_(layer.weight, c_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


class VectorQuantize(nn.Module):
    """One residual-VQ stage: project to ``codebook_dim``, pick the code of
    highest cosine similarity (full fp32), and pass the gradient straight
    through the lookup."""

    def __init__(self, input_dim: int, codebook_size: int = 1024, codebook_dim: int = 8,
                 generator=None):
        super().__init__()
        self.in_proj = _linear(input_dim, codebook_dim, generator)
        self.out_proj = _linear(codebook_dim, input_dim, generator)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim))
        with torch.no_grad():
            self.codebook.normal_(0.0, 1.0, generator=generator)

    def forward(self, z):
        """``z`` ``(B, D, T)`` -> ``(z_q (B, D, T), codes (B, T),
        commitment_loss, codebook_loss)``."""
        z_e = self.in_proj(z.transpose(1, 2))  # (B, T, cdim)
        codebook = _tp.local(self.codebook)
        z_n = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
        c_n = codebook / (torch.linalg.vector_norm(codebook, dim=-1, keepdim=True) + 1e-8)
        with strict_fp32():
            sim = z_n @ c_n.T  # (B, T, K)
        indices = sim.argmax(dim=-1)
        z_q = F.embedding(indices, codebook)

        commitment_loss = ((z_e - z_q.detach()) ** 2).mean()
        codebook_loss = ((z_q - z_e.detach()) ** 2).mean()

        z_q = z_e + (z_q - z_e).detach()  # straight through
        return self.out_proj(z_q).transpose(1, 2), indices, commitment_loss, codebook_loss

    def from_code(self, indices):
        """Stage codes ``(B, T)`` -> this stage's latents ``(B, D, T)``."""
        return self.out_proj(F.embedding(indices, _tp.local(self.codebook))).transpose(1, 2)


class ResidualVectorQuantize(nn.Module):
    """Cascade of VQ stages, each quantizing what the earlier ones left."""

    def __init__(self, input_dim: int = 256, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: int = 8, generator=None):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.quantizers = nn.ModuleList([
            VectorQuantize(input_dim, codebook_size, codebook_dim, generator)
            for _ in range(n_codebooks)
        ])

    def forward(self, z, n_quantizers: int = None):
        """``z`` ``(B, D, T)`` -> ``(z_q, codes (B, n_q, T), commitment_loss,
        codebook_loss)``, over the first ``n_quantizers`` stages (all by
        default)."""
        if n_quantizers is None:
            n_quantizers = self.n_codebooks
        z_q = torch.zeros_like(z)
        residual = z
        commitment_loss = codebook_loss = 0.0
        codes = []
        for quantizer in self.quantizers[:n_quantizers]:
            z_q_i, idx, commit, cb = quantizer(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            commitment_loss = commitment_loss + commit
            codebook_loss = codebook_loss + cb
            codes.append(idx)
        return z_q, torch.stack(codes, dim=1), commitment_loss, codebook_loss

    def from_codes(self, codes):
        """Codes ``(B, n_q, T)``, ``n_q`` any prefix of the cascade ->
        latents ``(B, D, T)``."""
        z_q = 0.0
        for i in range(min(codes.shape[1], self.n_codebooks)):
            z_q = z_q + self.quantizers[i].from_code(codes[:, i])
        return z_q


class DAC(BaseModel):
    """Descript-style audio codec (encoder, residual VQ, decoder).

    The defaults are the published 44.1 kHz configuration; scale
    ``encoder_dim`` and ``decoder_dim`` down for small runs. ``seed`` seeds
    the initialization. ``dtype`` (e.g. ``torch.bfloat16``) is the encoder's
    and decoder's compute dtype (module docstring); the parameters, the
    quantizer and the losses stay fp32. ``formulation`` is one of
    ``FORMULATIONS``, all computed as convs (module docstring).
    ``BaseModel`` records the constructor arguments, so ``save`` and
    ``load`` round-trip the configuration, ``dtype`` and ``formulation``
    included, with the weights.

    >>> model = DAC().cuda()
    >>> out = model(audio)          # (B, 1, T) -> dict
    >>> z_q, codes = model.encode(audio)
    >>> audio2 = model.decode_from_codes(codes)
    """

    def __init__(self, encoder_dim: int = 64, encoder_rates: Tuple[int, ...] = (2, 4, 8, 8),
                 latent_dim: int = 256, decoder_dim: int = 1024, n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: int = 8, sample_rate: int = 44100,
                 seed: int = 0, dtype: torch.dtype = None, formulation: str = "conv"):
        super().__init__()
        if formulation not in FORMULATIONS:
            raise ValueError(f"formulation must be one of {FORMULATIONS}, got {formulation!r}")
        self.formulation = formulation
        self.encoder_rates, self.sample_rate = tuple(encoder_rates), sample_rate
        self.n_codebooks, self.codebook_size = n_codebooks, codebook_size
        self.dtype = dtype
        generator = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(encoder_dim, self.encoder_rates, latent_dim, generator, dtype)
        self.quantizer = ResidualVectorQuantize(latent_dim, n_codebooks, codebook_size,
                                                codebook_dim, generator)
        self.decoder = Decoder(latent_dim, decoder_dim, tuple(reversed(self.encoder_rates)),
                               generator, dtype)

    @property
    def hop_length(self):
        return int(np.prod(self.encoder_rates))

    def _pad(self, audio):
        """``(B, 1, T)`` or ``(B, T)`` -> ``(B, 1, T)`` zero-padded to a
        multiple of the hop length."""
        x = audio if audio.ndim == 3 else audio[:, None]
        return F.pad(x, (0, (-x.shape[-1]) % self.hop_length))

    def forward(self, audio, n_quantizers: int = None):
        """Full pass of ``(B, 1, T)`` or ``(B, T)`` audio: a dict with
        ``audio`` ``(B, 1, T)``, ``z`` (quantized latents ``(B, D, T')``),
        ``codes`` ``(B, n_q, T')``, ``vq/commitment_loss`` and
        ``vq/codebook_loss``."""
        T = audio.shape[-1]
        with span("dac.encoder"):
            z = self.encoder(self._pad(audio))
        with span("dac.quantizer"):
            z_q, codes, commitment_loss, codebook_loss = self.quantizer(z, n_quantizers)
        with span("dac.decoder"):
            recon = self.decoder(z_q)[..., :T]
        return {
            "audio": recon,
            "z": z_q,
            "codes": codes,
            "vq/commitment_loss": commitment_loss,
            "vq/codebook_loss": codebook_loss,
        }

    def encode(self, audio, n_quantizers: int = None):
        """Audio -> quantized latents and codes; the decoder does not run."""
        with span("dac.encoder"):
            z = self.encoder(self._pad(audio))
        with span("dac.quantizer"):
            z_q, codes, _, _ = self.quantizer(z, n_quantizers)
        return z_q, codes

    def decode_from_latents(self, z_q):
        """Quantized latents ``(B, D, T')`` -> audio ``(B, 1, T' hop)``."""
        with span("dac.decoder"):
            return self.decoder(z_q)

    def decode_from_codes(self, codes):
        """Stored codes ``(B, n_q, T')`` (any prefix of the cascade) -> audio
        ``(B, 1, T' hop)``."""
        with span("dac.quantizer"):
            z_q = self.quantizer.from_codes(codes)
        return self.decode_from_latents(z_q)
