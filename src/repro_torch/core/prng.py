"""Threefry-2x32 counter-based random bits, drawn as JAX draws them.

The reference's fleet replay lowers each seed through ``jax.random``,
whose default generator is Threefry-2x32 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC'11: 20 rounds, rotation
constants R_{2x32}, key-schedule parity 0x1BD11BDA) with partitionable
counters. The integer part is exact, so this module draws the same bits
on any device:

* a key is a pair of 32-bit words (``key(seed)`` is ``[0, seed]``);
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``bits(key, shape)`` is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``
  over the flat index ``i`` of ``shape``.

The words are held in int64 tensors masked to 32 bits (torch has no
usable uint32 arithmetic), with a leading batch shape on every key: a
batch of seeds draws as one set of tensor operations. The float
transforms follow JAX's recipes (``uniform`` from the top 23 bits as a
float in [1, 2) less 1, ``normal`` through Giles' ``erfinv`` polynomial,
``categorical`` through Gumbel noise); they may differ from XLA's by a
few ulps (``log1p``, ``log``), never in the bits.

Each transcendental function of a float32 draw is evaluated in float64
and rounded once (:func:`f32`): ATen's CPU loops compute a float32
``exp`` or ``log`` with vector code for most elements and scalar code for
the rest, which may differ in the last bit, so a draw's value would
depend on where it sits in the batch. Rounded from float64 it does not,
and a seed lowers the same alone or in any batch.
"""
from __future__ import annotations

from typing import Sequence

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_I64 = torch.int64


def f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a float32 tensor, evaluated in float64 and rounded once
    to float32: the same bits wherever an element sits in its batch."""
    return fn(x.double()).float()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on 32-bit words held in int64 tensors
    (broadcast together). Returns the two output words."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """Key(s) of 32-bit seeds: (..., 2) int64 words ``[0, seed]``."""
    s = torch.as_tensor(seed, dtype=_I64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], -1)


def _hash(k: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """threefry2x32(k, (0, counter)) as (..., 2) words; ``k`` (..., 2)
    broadcast against ``counter``."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(counter),
                          counter)
    return torch.stack([y0, y1], -1)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` new keys from each key: (..., 2) -> (..., n, 2)."""
    ctr = torch.arange(n, dtype=_I64, device=k.device)
    return _hash(k[..., None, :], ctr)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from ``k`` and the 32-bit integer ``data``."""
    ctr = torch.full(k.shape[:-1], int(data) & _MASK, dtype=_I64,
                     device=k.device)
    return _hash(k, ctr)


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits a draw, (..., *shape) int64 in [0, 2^32): the flat
    index of ``shape`` is the counter."""
    shape = tuple(int(d) for d in shape)
    ctr = torch.arange(math.prod(shape), dtype=_I64,
                       device=k.device).view(shape)
    kk = k.view(k.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(kk[..., 0], kk[..., 1], torch.zeros_like(ctr), ctr)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the top 23 bits as a float in
    [1, 2), less 1, scaled and shifted, clamped below at ``minval``."""
    f = ((bits(k, shape) >> 9) | 0x3F800000).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# Giles' single-precision erfinv ("Approximating the erfinv function",
# GPU Computing Gems, 2011), the polynomial XLA lowers erf_inv to: w < 5
# and w >= 5 branches, Horner from the highest coefficient
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by Giles' polynomial; each Horner step is a product
    and a sum rounded once to float32 (a fused multiply-add, as XLA's CPU
    code contracts them)."""
    w = -f32(torch.log1p, -x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, a, b).double()
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0].float()
    for c in coef[1:]:
        p = (c + p.double() * w).float()
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1, x * big, p * x)


def normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard normal: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(k, shape, lo, 1.0)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32)


def bernoulli(k: torch.Tensor, p: float, shape: Sequence[int]):
    """Booleans, each true with probability ``p`` (float32 ``u < p``)."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32)


def categorical(k: torch.Tensor, logits: torch.Tensor,
                shape: Sequence[int]) -> torch.Tensor:
    """Draws from the categories of 1-D ``logits``: argmax of Gumbel noise
    of shape (*shape, M) plus the logits."""
    logits = torch.as_tensor(logits, dtype=torch.float32, device=k.device)
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(k, tuple(shape) + (logits.shape[-1],), tiny, 1.0)
    return torch.argmax(-f32(torch.log, -f32(torch.log, u)) + logits,
                        dim=-1)
