"""Counter-based random bits (Philox4x32-10) and the env rollout's reset noise.

The TPU kernel draws its reset noise from ``pltpu.prng_random_bits``, which
nothing off the TPU reproduces. The CUDA env-rollout kernel
(``csrc/env_rollout.cu``) computes Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011) by hand, and this module
computes the same function in torch for the plain version, so both see the
same noise env by env.

The key is ``(seed, env)`` and the counter ``(step, row, 0, 0)``; the noise
uses the first 32-bit output word. Torch has no unsigned 64-bit arithmetic,
and a 32 × 32-bit product overflows signed int64, so the products are taken
in 16-bit limbs on int64 tensors.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a · m`` for uint32 values in int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    ll, hl, lh, hh = a_lo * m_lo, a_hi * m_lo, a_lo * m_hi, a_hi * m_hi
    mid = (ll >> 16) + (hl & 0xFFFF) + (lh & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (hh + (hl >> 16) + (lh >> 16) + (mid >> 16)) & MASK32
    return hi, lo


def philox4x32(counter, key) -> list[torch.Tensor]:
    """Philox4x32-10 of a 4-word ``counter`` and a 2-word ``key``, each word
    an int64 tensor (or int) holding a uint32; the words broadcast."""
    c = [torch.as_tensor(x, dtype=torch.int64) & MASK32 for x in counter]
    k0, k1 = (torch.as_tensor(x, dtype=torch.int64) & MASK32 for x in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c[0], PHILOX_M0)
        hi1, lo1 = _mulhilo(c[2], PHILOX_M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def reset_noise(seed: int, step: int, batch: int, reset_noise_std: float, device=None) -> torch.Tensor:
    """``(3, B)`` uniform noise of standard deviation ``reset_noise_std`` on
    the respawned base position at rollout step ``step``, as the JAX kernel
    turns its bits into noise: ``u = (bits >> 8) · 2⁻²⁴`` and
    ``√3 · std · (2u − 1)``, in float32."""
    env = torch.arange(batch, dtype=torch.int64, device=device)
    half = torch.tensor(reset_noise_std * 3.0**0.5, dtype=torch.float32, device=device)
    rows = []
    for row in range(3):
        bits = philox4x32((step, row, 0, 0), (seed, env))[0]
        u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
        rows.append(half * (2.0 * u - 1.0))
    return torch.stack(rows)
