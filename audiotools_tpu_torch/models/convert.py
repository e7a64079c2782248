"""Weights from the JAX package's models to this package's.

A flax parameter tree, given as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``, with or without its ``"params"``
level), becomes a ``state_dict`` for :class:`~.dac.DAC` or
:class:`~.discriminators.Discriminator`. Every formulation of the JAX DAC
(``conv``, ``hybrid``, ``matmul``) has the same tree, so any of them
converts. A leaf the structure does not use, or one it needs and the tree
lacks, raises ``KeyError``.

Layouts (flax -> torch):

- ``nn.Conv`` kernel ``(k, in, out)`` -> ``Conv1d`` weight ``(out, in, k)``;
  2-D ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``.
- ``nn.ConvTranspose`` kernel ``(k, in, out)`` -> ``ConvTranspose1d`` weight
  ``(in, out, k)`` with the taps reversed: flax does not flip the kernel
  (``transpose_kernel=False``), torch's transposed conv does.
- ``nn.Dense`` kernel ``(in, out)`` -> ``Linear`` weight ``(out, in)``.
- Snake ``alpha`` ``(1, 1, C)`` -> ``(1, C, 1)``.
- ``nn.WeightNorm``'s gain, stored as ``WeightNorm_i/{"Conv_i/kernel/scale"}``
  beside the unnormalized ``Conv_i/kernel``, -> ``scale`` of the conv.
"""
from typing import Mapping

import numpy as np
import torch

__all__ = ["dac_state_dict", "discriminator_state_dict"]


class _Tree:
    """A flax tree's leaves by path, recording which were read."""

    def __init__(self, params: Mapping):
        if "params" in params and len(params) == 1:
            params = params["params"]
        self.tree = params
        self.leaves = {}
        self._flatten(params, ())
        self.used = set()

    def _flatten(self, node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                self._flatten(value, path + (key,))
            else:
                self.leaves[path + (key,)] = value

    def count(self, path, prefix):
        """How many children ``prefix0``, ``prefix1``, ... the node at
        ``path`` has (0 if the node is missing)."""
        node = self.tree
        for key in path:
            node = node.get(key, {})
        n = 0
        while f"{prefix}{n}" in node:
            n += 1
        return n

    def take(self, *path):
        if path not in self.leaves:
            raise KeyError(f"the JAX tree lacks {'/'.join(path)}")
        self.used.add(path)
        return np.asarray(self.leaves[path], dtype=np.float32)

    def check_all_used(self):
        unknown = sorted("/".join(p) for p in set(self.leaves) - self.used)
        if unknown:
            raise KeyError(f"the JAX tree has leaves no module takes: {unknown}")


def _put(out, name, array):
    out[name] = torch.from_numpy(np.ascontiguousarray(array))


def _conv(tree, path, out, name):
    kernel = tree.take(*path, "kernel")
    _put(out, f"{name}.weight", kernel.transpose((2, 1, 0) if kernel.ndim == 3 else (3, 2, 0, 1)))
    _put(out, f"{name}.bias", tree.take(*path, "bias"))


def _conv_transpose(tree, path, out, name):
    _put(out, f"{name}.weight", tree.take(*path, "kernel")[::-1].transpose(1, 2, 0))
    _put(out, f"{name}.bias", tree.take(*path, "bias"))


def _dense(tree, path, out, name):
    _put(out, f"{name}.weight", tree.take(*path, "kernel").T)
    _put(out, f"{name}.bias", tree.take(*path, "bias"))


def _snake(tree, path, out, name):
    _put(out, f"{name}.alpha", tree.take(*path, "alpha").reshape(1, -1, 1))


def _residual_unit(tree, path, out, name):
    _snake(tree, path + ("Snake_0",), out, f"{name}.snake1")
    _conv(tree, path + ("Conv_0",), out, f"{name}.conv1")
    _snake(tree, path + ("Snake_1",), out, f"{name}.snake2")
    _conv(tree, path + ("Conv_1",), out, f"{name}.conv2")


def dac_state_dict(params: Mapping) -> dict:
    """``state_dict`` of :class:`~.dac.DAC` from the JAX DAC's parameters."""
    tree, out = _Tree(params), {}
    enc = ("encoder",)
    _conv(tree, enc + ("Conv_0",), out, "encoder.conv_in")
    for b in range(tree.count(enc, "EncoderBlock_")):
        path, name = enc + (f"EncoderBlock_{b}",), f"encoder.blocks.{b}"
        for u in range(3):
            _residual_unit(tree, path + (f"ResidualUnit_{u}",), out, f"{name}.units.{u}")
        _snake(tree, path + ("Snake_0",), out, f"{name}.snake")
        _conv(tree, path + ("Conv_0",), out, f"{name}.conv")
    _snake(tree, enc + ("Snake_0",), out, "encoder.snake")
    _conv(tree, enc + ("Conv_1",), out, "encoder.conv_out")

    for i in range(tree.count(("quantizer",), "quantizer_")):
        path, name = ("quantizer", f"quantizer_{i}"), f"quantizer.quantizers.{i}"
        _dense(tree, path + ("in_proj",), out, f"{name}.in_proj")
        _dense(tree, path + ("out_proj",), out, f"{name}.out_proj")
        _put(out, f"{name}.codebook", tree.take(*path, "codebook"))

    dec = ("decoder",)
    _conv(tree, dec + ("Conv_0",), out, "decoder.conv_in")
    for b in range(tree.count(dec, "DecoderBlock_")):
        path, name = dec + (f"DecoderBlock_{b}",), f"decoder.blocks.{b}"
        _snake(tree, path + ("Snake_0",), out, f"{name}.snake")
        _conv_transpose(tree, path + ("ConvTranspose_0",), out, f"{name}.conv")
        for u in range(3):
            _residual_unit(tree, path + (f"ResidualUnit_{u}",), out, f"{name}.units.{u}")
    _snake(tree, dec + ("Snake_0",), out, "decoder.snake")
    _conv(tree, dec + ("Conv_1",), out, "decoder.conv_out")
    tree.check_all_used()
    return out


def _wn_conv(tree, path, i, out, name):
    """``Conv_i`` of a sub-discriminator and, when the tree has it, the gain
    of ``WeightNorm_i``."""
    _conv(tree, path + (f"Conv_{i}",), out, name)
    if f"WeightNorm_{i}" in tree.tree[path[0]]:
        _put(out, f"{name}.scale",
             tree.take(*path, f"WeightNorm_{i}", f"Conv_{i}/kernel/scale"))


def discriminator_state_dict(params: Mapping) -> dict:
    """``state_dict`` of :class:`~.discriminators.Discriminator` from the JAX
    Discriminator's parameters."""
    tree, out = _Tree(params), {}
    for i in range(tree.count((), "mpd_")):
        path = (f"mpd_{i}",)
        n = tree.count(path, "Conv_")
        for j in range(n - 1):
            _wn_conv(tree, path, j, out, f"mpd.{i}.layers.{j}")
        _wn_conv(tree, path, n - 1, out, f"mpd.{i}.logits")
    for i in range(tree.count((), "mrd_")):
        path = (f"mrd_{i}",)
        n = tree.count(path, "Conv_")
        for j in range(n - 1):  # five convs a band
            _wn_conv(tree, path, j, out, f"mrd.{i}.band_convs.{j // 5}.{j % 5}")
        _wn_conv(tree, path, n - 1, out, f"mrd.{i}.logits")
    tree.check_all_used()
    return out
