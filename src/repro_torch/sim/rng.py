"""Counter-based randomness for the fleet simulator.

Both simulator paths — the batched epoch engine (``repro_torch.sim.engine``)
and the pure-Python event-loop oracle (``repro_torch.sim.oracle``) — must
consume *identical* random bits so their event sequences can be compared
bit for bit. Sequential generators (``np.random.Generator``) make that
impossible: the two paths draw in different orders (the engine batches an
epoch's draws across trials; the oracle runs one trial to completion). The
fix is counter-based addressing: every draw is named by a
``(trial, stream, seq)`` triple and hashed independently through a
threefry-2x32 ``fold_in`` chain — order of evaluation cannot matter
because there is no shared cursor.

* ``stream`` identifies the renewal process (disk-``d`` lifetime, node-``i``
  burst, per-disk latent-error arrivals, the repair channel —
  :class:`repro_torch.sim.units.UnitHierarchy` assigns the ids).
* ``seq`` counts that stream's draws within the trial.

The chain is the threefry PRNG of the reference simulator (the JAX
package's ``jax.random`` chain, partitionable threefry on): the key of
seed ``s`` is ``(0, s mod 2^32)``, ``fold_in(k, d)`` is
``threefry2x32(k, (0, d))``, and a key's 32 bits are ``x0 ^ x1`` of
``threefry2x32(k, (0, 0))``. So a triple's bits are those the reference
draws for it, and seeded runs of the two agree event for event.

:class:`BitSource` evaluates a batch of triples in one call of
:func:`threefry_bits` on torch tensors on its device (the card unless the
caller asks for the host): the chain runs on 64-bit integers masked to 32
bits after every add and shift, since not every torch build has the
shifts and adds of ``uint32``. :func:`threefry_bits_np` is the same chain
in numpy ``uint32``, the plain version the tests and the smoke script hold
the device's bits to.

The uint32 -> duration transforms run in *numpy float64* on the host and
round once to float32 (the simulator's time grid). Keeping the transform
off the device makes it exactly reproducible whatever device drew the
bits (a device ``log1p`` need not round like numpy's); keeping the grid
float32 gives both paths one canonical rounding of every timestamp.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_TRIPLE = np.dtype(np.uint32)
_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                   # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1, rotl, mask):
    """Threefry-2x32 with 20 rounds over ``(x0, x1)`` under key
    ``(k0, k1)``; ``rotl`` and ``mask`` give the integer type's 32-bit
    rotation and wrap, so one schedule serves torch and numpy."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = mask(x0 + ks[0])
    x1 = mask(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = mask(x0 + x1)
            x1 = rotl(x1, r) ^ x0
        x0 = mask(x0 + ks[(i + 1) % 3])
        x1 = mask(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _chain(k0, k1, trial, stream, seq, rotl, mask, zero):
    """Bits of ``fold_in(fold_in(fold_in(key, trial), stream), seq)``."""
    for d in (trial, stream, seq):
        k0, k1 = _threefry2x32(k0, k1, zero, d, rotl, mask)
    b0, b1 = _threefry2x32(k0, k1, zero, zero, rotl, mask)
    return b0 ^ b1


def threefry_bits(key: tuple[int, int], triples: torch.Tensor
                  ) -> torch.Tensor:
    """uint32 bits (as int64) of each ``(trial, stream, seq)`` row of an
    ``(n, 3)`` int64 tensor, on the tensor's device."""
    def mask(x):
        return x & _MASK

    def rotl(x, r):
        return ((x << r) & _MASK) | (x >> (32 - r))

    zero = torch.zeros_like(triples[:, 0])
    return _chain(zero + key[0], zero + key[1], triples[:, 0],
                  triples[:, 1], triples[:, 2], rotl, mask, zero)


def threefry_bits_np(key: tuple[int, int], triples: np.ndarray
                     ) -> np.ndarray:
    """:func:`threefry_bits` in numpy ``uint32`` (wrapping arithmetic):
    the plain version, for checks only."""
    t = np.asarray(triples, dtype=np.uint32).reshape(-1, 3)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    zero = np.zeros(len(t), np.uint32)
    with np.errstate(over="ignore"):
        return _chain(zero + np.uint32(key[0]), zero + np.uint32(key[1]),
                      t[:, 0], t[:, 1], t[:, 2], rotl, lambda x: x, zero)


class BitSource:
    """uint32 bits addressed by ``(trial, stream, seq)``, seeded once.

    ``bits(triples)`` evaluates a ``(n, 3)`` uint32 array of triples in one
    batched call on ``device`` (the card by default; ``device="cpu"`` runs
    the same torch chain on the host): one copy in, one copy out. ``bit1``
    is the oracle's scalar convenience — one device round trip per draw.
    """

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        self.seed = int(seed)
        self.key = (0, self.seed & _MASK)
        self.device = resolve_device(device)

    def bits(self, triples: np.ndarray) -> np.ndarray:
        triples = np.asarray(triples, dtype=_TRIPLE).reshape(-1, 3)
        if len(triples) == 0:
            return np.zeros(0, dtype=np.uint32)
        dev = torch.from_numpy(triples.astype(np.int64)).to(self.device)
        return threefry_bits(self.key, dev).cpu().numpy().astype(np.uint32)

    def bit1(self, trial: int, stream: int, seq: int) -> np.uint32:
        return self.bits(np.array([[trial, stream, seq]], dtype=_TRIPLE))[0]


def uniform01(bits) -> np.ndarray:
    """uint32 -> open (0, 1) float64: ``(bits + 0.5) * 2^-32``. Strictly
    inside the interval, so ``log1p(-u)`` below is always finite."""
    return (np.asarray(bits, dtype=np.float64) + 0.5) * 2.0 ** -32


def exp_hours(bits, mean_hours: float) -> np.ndarray:
    """Exponential durations with the given mean, rounded once to the
    float32 time grid."""
    u = uniform01(bits)
    return np.float32(np.float64(mean_hours) * -np.log1p(-u))


def weibull_hours(bits, scale_hours: float, shape: float) -> np.ndarray:
    """Weibull durations (inverse-CDF), rounded once to float32.
    ``shape=1`` degenerates to the exponential — the calibration mode the
    closed-form Markov chain assumes."""
    u = uniform01(bits)
    dur = np.float64(scale_hours) * (-np.log1p(-u)) ** (1.0 / np.float64(shape))
    return np.float32(dur)


def weibull_scale(mean_hours: float, shape: float) -> float:
    """The Weibull scale whose mean is ``mean_hours`` at ``shape``:
    ``scale = mean / Gamma(1 + 1/shape)``."""
    from math import gamma

    return float(mean_hours) / gamma(1.0 + 1.0 / float(shape))


def later(t, dur) -> np.float32:
    """``t + dur`` on the float32 time grid (single canonical rounding —
    both simulator paths schedule every event through this)."""
    return np.float32(np.float32(t) + np.float32(dur))
