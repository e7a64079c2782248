"""Plain reference of the DAC codec (descript-audio-codec ``dac/model/dac.py``)
in ``torch.nn.functional``, over a flat dict of weights, and the seeded
weights themselves.

Departures from the published model, which are the program's own:

- convolutions carry no weight norm (plain kernels and biases, initialized
  as flax initializes them);
- the residual units pad their dilated convolutions to keep the length
  (the published units crop the input instead);
- the quantizer uses every codebook on every step (no quantizer dropout).

``param_specs`` lists every weight with its shape and initial deviation,
under the names the program's modules give them, so one set of seeded
weights can be handed to both sides. Nothing of the program is imported.
"""
import math

import torch
import torch.nn.functional as F


def _units(prefix, dim, specs):
    for j, _dilation in enumerate((1, 3, 9)):
        p = f"{prefix}.units.{j}"
        specs += [(f"{p}.snake1.alpha", (1, dim, 1), "ones"),
                  (f"{p}.conv1.weight", (dim, dim, 7), math.sqrt(1.0 / (7 * dim))),
                  (f"{p}.conv1.bias", (dim,), "zeros"),
                  (f"{p}.snake2.alpha", (1, dim, 1), "ones"),
                  (f"{p}.conv2.weight", (dim, dim, 1), 1e-2),
                  (f"{p}.conv2.bias", (dim,), "zeros")]


def param_specs(encoder_dim=64, encoder_rates=(2, 4, 8, 8), latent_dim=256, decoder_dim=1024,
                n_codebooks=9, codebook_size=1024, codebook_dim=8, **_):
    """``[(name, shape, init)]``: ``init`` a deviation, ``"ones"`` or
    ``"zeros"``. Conv kernels ``(out, in, k)``, transposed ``(in, out, k)``,
    dense ``(out, in)``; deviations ``1 / sqrt(fan_in)``, the residual units'
    output convs ``1e-2``, codebooks ``1``."""
    specs = []

    def conv(name, cin, cout, k):
        specs.extend([(f"{name}.weight", (cout, cin, k), math.sqrt(1.0 / (k * cin))),
                      (f"{name}.bias", (cout,), "zeros")])

    d = encoder_dim
    conv("encoder.conv_in", 1, d, 7)
    for i, stride in enumerate(encoder_rates):
        _units(f"encoder.blocks.{i}", d, specs)
        specs.append((f"encoder.blocks.{i}.snake.alpha", (1, d, 1), "ones"))
        conv(f"encoder.blocks.{i}.conv", d, 2 * d, 2 * stride)
        d *= 2
    specs.append(("encoder.snake.alpha", (1, d, 1), "ones"))
    conv("encoder.conv_out", d, latent_dim, 3)
    for k in range(n_codebooks):
        p = f"quantizer.quantizers.{k}"
        specs += [(f"{p}.in_proj.weight", (codebook_dim, latent_dim),
                   math.sqrt(1.0 / latent_dim)),
                  (f"{p}.in_proj.bias", (codebook_dim,), "zeros"),
                  (f"{p}.out_proj.weight", (latent_dim, codebook_dim),
                   math.sqrt(1.0 / codebook_dim)),
                  (f"{p}.out_proj.bias", (latent_dim,), "zeros"),
                  (f"{p}.codebook", (codebook_size, codebook_dim), 1.0)]
    d = decoder_dim
    conv("decoder.conv_in", latent_dim, d, 7)
    for i, stride in enumerate(reversed(encoder_rates)):
        specs.append((f"decoder.blocks.{i}.snake.alpha", (1, d, 1), "ones"))
        specs += [(f"decoder.blocks.{i}.conv.weight", (d, d // 2, 2 * stride),
                   math.sqrt(1.0 / (2 * stride * d))),
                  (f"decoder.blocks.{i}.conv.bias", (d // 2,), "zeros")]
        d //= 2
        _units(f"decoder.blocks.{i}", d, specs)
    specs.append(("decoder.snake.alpha", (1, d, 1), "ones"))
    conv("decoder.conv_out", d, 1, 7)
    return specs


def make_weights(specs, seed, device, dtype=torch.float32):
    """Weights of ``specs`` from ``seed``: one normal draw on ``device`` for
    all of them, scaled by each deviation; ones and zeros as named."""
    n = sum(math.prod(shape) for _, shape, init in specs if not isinstance(init, str))
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    flat = torch.randn(n, generator=g, device=device, dtype=dtype)
    weights, offset = {}, 0
    for name, shape, init in specs:
        if init == "ones":
            weights[name] = torch.ones(shape, device=device, dtype=dtype)
        elif init == "zeros":
            weights[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            size = math.prod(shape)
            weights[name] = flat[offset: offset + size].view(shape) * init
            offset += size
    return weights


def snake(x, alpha):
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


def identity(x):
    return x


def _conv(w, name, x, stride=1, padding=0, dilation=1, q=identity):
    """``q`` rounds the products' operands (the control's lower precision)."""
    return F.conv1d(q(x), q(w[f"{name}.weight"]), w[f"{name}.bias"], stride, padding, dilation)


def _residual(w, p, x, q=identity):
    for j, dilation in enumerate((1, 3, 9)):
        u = f"{p}.units.{j}"
        y = _conv(w, f"{u}.conv1", snake(x, w[f"{u}.snake1.alpha"]), padding=3 * dilation,
                  dilation=dilation, q=q)
        x = x + _conv(w, f"{u}.conv2", snake(y, w[f"{u}.snake2.alpha"]), q=q)
    return x


def encode_latents(w, audio, rates, q=identity):
    """``(B, 1, T)`` audio, ``T`` a multiple of the hop -> latents ``(B, D, T')``."""
    x = _conv(w, "encoder.conv_in", audio, padding=3, q=q)
    for i, stride in enumerate(rates):
        x = _residual(w, f"encoder.blocks.{i}", x, q)
        x = _conv(w, f"encoder.blocks.{i}.conv", snake(x, w[f"encoder.blocks.{i}.snake.alpha"]),
                  stride=stride, padding=math.ceil(stride / 2), q=q)
    return _conv(w, "encoder.conv_out", snake(x, w["encoder.snake.alpha"]), padding=1, q=q)


def _unit(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)


def quantize(w, z, n_codebooks, q=identity):
    """Residual VQ: each stage projects what the earlier stages left,
    picks the code of highest cosine similarity, and passes the gradient
    straight through. Returns ``(z_q, codes (B, n_q, T'), commitment,
    codebook)``."""
    z_q, residual = torch.zeros_like(z), z
    commitment = codebook_loss = 0.0
    codes = []
    for k in range(n_codebooks):
        p = f"quantizer.quantizers.{k}"
        z_e = F.linear(q(residual.transpose(1, 2)), q(w[f"{p}.in_proj.weight"]),
                       w[f"{p}.in_proj.bias"])
        book = w[f"{p}.codebook"]
        idx = (q(_unit(z_e)) @ q(_unit(book)).T).argmax(-1)
        chosen = F.embedding(idx, book)
        commitment = commitment + ((z_e - chosen.detach()) ** 2).mean()
        codebook_loss = codebook_loss + ((chosen - z_e.detach()) ** 2).mean()
        chosen = z_e + (chosen - z_e).detach()
        out = F.linear(q(chosen), q(w[f"{p}.out_proj.weight"]),
                       w[f"{p}.out_proj.bias"]).transpose(1, 2)
        z_q, residual = z_q + out, residual - out
        codes.append(idx)
    return z_q, torch.stack(codes, 1), commitment, codebook_loss


def code_gaps(w, z, codes):
    """For each stage along the given ``codes``: how far the chosen code's
    cosine similarity lies below the best one's, from the reference's
    residuals. Returns the widest gap, and the latents the codes stand
    for."""
    residual, z_q, worst = z, torch.zeros_like(z), 0.0
    for k in range(codes.shape[1]):
        p = f"quantizer.quantizers.{k}"
        z_e = F.linear(residual.transpose(1, 2), w[f"{p}.in_proj.weight"], w[f"{p}.in_proj.bias"])
        book = w[f"{p}.codebook"]
        sim = _unit(z_e) @ _unit(book).T
        chosen = sim.gather(-1, codes[:, k, :, None].long())[..., 0]
        worst = max(worst, float((sim.amax(-1) - chosen).max()))
        out = from_code(w, k, codes[:, k])
        z_q, residual = z_q + out, residual - out
    return worst, z_q


def from_code(w, k, idx):
    p = f"quantizer.quantizers.{k}"
    return F.linear(F.embedding(idx.long(), w[f"{p}.codebook"]), w[f"{p}.out_proj.weight"],
                    w[f"{p}.out_proj.bias"]).transpose(1, 2)


def decode(w, z_q, rates, q=identity):
    """Latents -> ``(B, 1, T' hop)`` audio in (-1, 1)."""
    x = _conv(w, "decoder.conv_in", z_q, padding=3, q=q)
    for i, stride in enumerate(reversed(rates)):
        if stride % 2:
            raise ValueError("the reference's transposed convs take even strides")
        x = snake(x, w[f"decoder.blocks.{i}.snake.alpha"])
        # up by ``stride`` to exactly ``stride`` times the length
        x = F.conv_transpose1d(q(x), q(w[f"decoder.blocks.{i}.conv.weight"]),
                               w[f"decoder.blocks.{i}.conv.bias"], stride=stride,
                               padding=stride // 2)
        x = _residual(w, f"decoder.blocks.{i}", x, q)
    return torch.tanh(_conv(w, "decoder.conv_out", snake(x, w["decoder.snake.alpha"]), padding=3,
                            q=q))


def forward(w, audio, widths, q=identity):
    """The generator's training pass: ``(recon (B, 1, T), commitment,
    codebook)``; ``q`` rounds the products' operands."""
    rates = widths["encoder_rates"]
    hop = math.prod(rates)
    T = audio.shape[-1]
    x = F.pad(audio, (0, (-T) % hop))
    z_q, _, commitment, codebook_loss = quantize(w, encode_latents(w, x, rates, q),
                                                 widths["n_codebooks"], q)
    return decode(w, z_q, rates, q)[..., :T], commitment, codebook_loss
