"""Plain reference of DAC's adversarial training step: the multi-period and
multi-resolution band discriminators, the reconstruction, VQ, LSGAN and
feature-matching losses, and AdamW, in ``torch.nn.functional`` over flat
dicts of weights (descript-audio-codec ``dac/model/discriminator.py``,
``dac/nn/loss.py``, ``scripts/train.py``).

Departures from the published recipe, which are the program's own:

- the reconstruction loss is the program's: waveform L1 (weight 1), a mel
  loss over two scales (150 mels at 2048, 80 at 512; log10 of the squared
  mel plus its L1, weight 15), a two-scale STFT magnitude loss (weight 1)
  and the VQ terms (0.25, 1); the published recipe weighs a seven-scale mel
  loss at 15 and no waveform or STFT term;
- the adversarial terms weigh 1 (LSGAN) and 2 (feature matching), as
  published; no gradient clipping and no learning-rate schedule;
- the discriminators' convolutions are SAME-padded with the smaller half
  low, weight-normalized as ``scale v / sqrt(sum v^2 + 1e-12)``, and the MRD
  reads the complex STFT as a (re, im) image cut into five bands.

The update order is the program's: the generator first against the current
discriminators, then the discriminators on the detached reconstruction.
"""
import math

import torch
import torch.nn.functional as F

from . import chain as _dsp
from . import dac as _dac

LEAK = 0.1
BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
LOSS_WEIGHTS = {"waveform": 1.0, "mel": 15.0, "stft": 1.0, "commitment": 0.25, "codebook": 1.0,
                "adv": 1.0, "feature": 2.0}


def disc_specs(periods=(2, 3, 5, 7, 11), fft_sizes=(2048, 1024, 512),
               mpd_channels=(32, 128, 512, 1024), mrd_channels=32):
    """``[(name, shape, init)]`` of the discriminators, under the program's
    module names: kernels ``(out, in, kh, kw)`` at ``1 / sqrt(fan_in)``,
    biases zero, weight-norm scales one."""
    specs = []

    def conv(name, cin, cout, kh, kw):
        specs.extend([(f"{name}.weight", (cout, cin, kh, kw), math.sqrt(1.0 / (cin * kh * kw))),
                      (f"{name}.bias", (cout,), "zeros"), (f"{name}.scale", (cout,), "ones")])

    for i, _p in enumerate(periods):
        c = 1
        for j, ch in enumerate(mpd_channels):
            conv(f"mpd.{i}.layers.{j}", c, ch, 5, 1)
            c = ch
        conv(f"mpd.{i}.layers.{len(mpd_channels)}", c, c, 5, 1)
        conv(f"mpd.{i}.logits", c, 1, 3, 1)
    for i, _n in enumerate(fft_sizes):
        for b in range(len(BANDS)):
            for j in range(4):
                conv(f"mrd.{i}.band_convs.{b}.{j}", 2 if j == 0 else mrd_channels,
                     mrd_channels, 3, 9)
            conv(f"mrd.{i}.band_convs.{b}.4", mrd_channels, mrd_channels, 3, 3)
        conv(f"mrd.{i}.logits", mrd_channels, 1, 3, 3)
    return specs


def _same(n, k, s):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def wn_conv2d(w, name, x, stride=(1, 1), q=_dac.identity):
    """``q`` rounds the convolution's operands (the control's precision)."""
    v = w[f"{name}.weight"]
    kernel = w[f"{name}.scale"][:, None, None, None] * v * torch.rsqrt(
        (v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
    (h0, h1), (w0, w1) = (_same(n, k, s) for n, k, s in zip(x.shape[-2:], v.shape[-2:], stride))
    return F.conv2d(q(F.pad(x, (w0, w1, h0, h1))), q(kernel), w[f"{name}.bias"], stride)


def mpd(w, i, period, x, n_layers=4, q=_dac.identity):
    B, T = x.shape
    if T % period:
        x = F.pad(x[:, None], (0, (-T) % period), mode="replicate")[:, 0]
    h = x.reshape(B, 1, -1, period)
    feats = []
    for j in range(n_layers + 1):
        h = F.leaky_relu(wn_conv2d(w, f"mpd.{i}.layers.{j}", h,
                                   (3, 1) if j < n_layers else (1, 1), q), LEAK)
        feats.append(h)
    feats.append(wn_conv2d(w, f"mpd.{i}.logits", h, q=q))
    return feats


def mrd(w, i, n_fft, x, q=_dac.identity):
    # the STFT in fp32 at least: cuFFT takes no bf16 (the control's convs)
    spec = _dsp.stft(x.float(), n_fft, n_fft // 4).transpose(-1, -2)  # (B, frames, bins)
    img = torch.stack([spec.real, spec.imag], dim=1)
    bins = img.shape[-1]
    edges = [int(round(lo * bins)) for lo, _ in BANDS] + [bins]
    feats, outs = [], []
    for b in range(len(BANDS)):
        h = img[..., edges[b]: edges[b + 1]]
        for j in range(5):
            h = F.leaky_relu(wn_conv2d(w, f"mrd.{i}.band_convs.{b}.{j}", h,
                                       (1, 2) if 0 < j < 4 else (1, 1), q), LEAK)
            feats.append(h)
        outs.append(h)
    feats.append(wn_conv2d(w, f"mrd.{i}.logits", torch.cat(outs, dim=-1), q=q))
    return feats


def discriminate(w, audio, periods, fft_sizes, n_layers=4, q=_dac.identity):
    """Feature maps of every sub-discriminator, MPD first, logits last;
    ``n_layers``: the MPD's strided convs."""
    x = audio[:, 0]
    return ([mpd(w, i, p, x, n_layers, q) for i, p in enumerate(periods)]
            + [mrd(w, i, n, x, q) for i, n in enumerate(fft_sizes)])


def _spectral(x_feat, y_feat):
    log = (torch.log10(x_feat.clamp(min=1e-5) ** 2) - torch.log10(y_feat.clamp(min=1e-5) ** 2))
    return log.abs().mean() + (x_feat - y_feat).abs().mean()


def reconstruction_losses(recon, audio, sr):
    """``{"waveform", "mel", "stft"}`` of ``(B, 1, T)`` audio."""
    x, y = recon[:, 0].float(), audio[:, 0].float()
    mel = stft = 0.0
    for n_mels, n_fft in ((150, 2048), (80, 512)):
        basis = torch.as_tensor(_dsp.mel_basis(sr, n_fft, n_mels), dtype=x.dtype,
                                device=x.device)
        mx, my = _dsp.stft(x, n_fft, n_fft // 4).abs(), _dsp.stft(y, n_fft, n_fft // 4).abs()
        mel = mel + _spectral(basis @ mx, basis @ my)
        stft = stft + _spectral(mx, my)
    return {"waveform": (x - y).abs().mean(), "mel": mel, "stft": stft}


def adamw(params, grads, state, step, lr, betas, eps, weight_decay):
    """One AdamW update in place (decoupled decay, bias-corrected moments)."""
    b1, b2 = betas
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * weight_decay)
            denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_step(gen, disc, g_state, d_state, step, audio, widths, disc_cfg, opt, sr,
               q=_dac.identity):
    """One adversarial step on ``audio`` ``(B, 1, T)``: updates the weight
    dicts ``gen`` and ``disc`` and their optimizer states in place; returns
    the losses and both gradients. ``q`` rounds every convolution's and
    dense layer's operands (the control's lower precision)."""
    periods, fft_sizes = disc_cfg["periods"], disc_cfg["fft_sizes"]
    n_layers = len(disc_cfg.get("mpd_channels", (32, 128, 512, 1024)))
    g = {k: v.detach().requires_grad_(True) for k, v in gen.items()}
    recon, commitment, codebook = _dac.forward(g, audio, widths, q)
    parts = reconstruction_losses(recon, audio, sr)
    parts.update(commitment=commitment, codebook=codebook)
    fake = discriminate(disc, recon, periods, fft_sizes, n_layers, q)
    with torch.no_grad():
        real = discriminate(disc, audio, periods, fft_sizes, n_layers, q)
    adv = sum(((1.0 - f[-1]) ** 2).mean() for f in fake)
    feature = sum((r - f).abs().mean() for rs, fs in zip(real, fake)
                  for r, f in zip(rs[:-1], fs[:-1]))
    loss = sum(LOSS_WEIGHTS[k] * v for k, v in parts.items())
    loss = loss + LOSS_WEIGHTS["adv"] * adv + LOSS_WEIGHTS["feature"] * feature
    g_grads = dict(zip(g, torch.autograd.grad(loss, list(g.values()))))
    adamw(gen, g_grads, g_state, step, **opt)
    del g, fake, real

    d = {k: v.detach().requires_grad_(True) for k, v in disc.items()}
    recon = recon.detach()
    d_loss = sum(((1.0 - r[-1]) ** 2).mean() + (f[-1] ** 2).mean()
                 for r, f in zip(discriminate(d, audio, periods, fft_sizes, n_layers, q),
                                 discriminate(d, recon, periods, fft_sizes, n_layers, q)))
    d_grads = dict(zip(d, torch.autograd.grad(d_loss, list(d.values()))))
    adamw(disc, d_grads, d_state, step, **opt)
    return ({"loss": float(loss.detach()), "loss/discriminator": float(d_loss.detach())},
            g_grads, d_grads)
