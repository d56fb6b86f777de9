"""Smooth terrain models, counterpart of ``jaxsim_tpu/terrain/terrain.py``.

A terrain is a height field z = h(x, y) with an outward unit normal. The
classes are frozen dataclasses over plain floats and tuples, as in the JAX
package; ``height`` and ``normal`` take tensors (batched over leading dims)
and compute in their dtype. The grid heightmap is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Terrain:
    """Base terrain: a height field and its outward unit normal."""

    def height(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def normal(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FlatTerrain(Terrain):
    """Horizontal plane z = height."""

    _height: float = 0.0

    @staticmethod
    def build(height: float = 0.0) -> "FlatTerrain":
        return FlatTerrain(_height=float(height))

    def height(self, x, y):
        x = torch.as_tensor(x)
        return torch.full_like(x, self._height)

    def normal(self, x, y):
        x = torch.as_tensor(x)
        n = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
        n[..., 2] = 1.0
        return n


@dataclasses.dataclass(frozen=True)
class PlaneTerrain(FlatTerrain):
    """Inclined plane through (0, 0, height) with the given normal, which
    :meth:`build` normalises."""

    _normal: tuple[float, float, float] = (0.0, 0.0, 1.0)

    @staticmethod
    def build(height: float = 0.0, *, normal: tuple[float, float, float] = (0.0, 0.0, 1.0)) -> "PlaneTerrain":
        n = np.array(normal, dtype=float)
        norm = np.linalg.norm(n)
        if norm == 0 or n[2] <= 0:
            raise ValueError(f"Invalid plane normal: {normal}")
        n = n / norm
        return PlaneTerrain(_height=float(height), _normal=tuple(n.tolist()))

    def height(self, x, y):
        # a x + b y + c (z - h) = 0, so z = h - (a x + b y) / c.
        a, b, c = self._normal
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        return self._height - (a * x + b * y) / c

    def normal(self, x, y):
        x = torch.as_tensor(x)
        n = torch.tensor(self._normal, dtype=x.dtype, device=x.device)
        return n.expand(x.shape + (3,))


@dataclasses.dataclass(frozen=True)
class FourierTerrain(Terrain):
    """Spectral rough terrain, ``h(x, y) = h0 + Σ_k A_k sin(kx_k x + ky_k y
    + φ_k)``, with its analytic normal: an infinitely extended, smooth rough
    terrain that the kernels evaluate per contact point with sin and cos."""

    _h0: float = 0.0
    _amp: tuple = ()
    _kx: tuple = ()
    _ky: tuple = ()
    _phase: tuple = ()

    @staticmethod
    def build(
        *,
        seed: int = 0,
        num_components: int = 8,
        amplitude: float = 0.04,
        wavelength: float = 1.0,
        height: float = 0.0,
        spectrum=None,
    ) -> "FourierTerrain":
        """A random isotropic spectrum, drawn as the JAX package draws it
        (``np.random.default_rng(seed)``, so a seed gives the same spectrum
        bit for bit): directions uniform on the circle, wavenumbers
        log-uniform in [2π/λ, 3·2π/λ], amplitudes ∝ 1/k normalised to a
        height RMS of ``amplitude``, phases uniform. ``spectrum = (amp, kx,
        ky, phase)`` gives an explicit one."""
        if spectrum is not None:
            amp, kx, ky, phase = (np.asarray(a, dtype=float) for a in spectrum)
        else:
            rng = np.random.default_rng(seed)
            th = rng.uniform(0.0, 2 * np.pi, num_components)
            k0 = 2 * np.pi / wavelength
            k = np.exp(rng.uniform(np.log(k0), np.log(3 * k0), num_components))
            amp = 1.0 / k
            # The RMS of Σ A_k sin(·) with independent phases is √(Σ A_k²/2).
            amp = amp * (amplitude / np.sqrt(np.sum(amp**2) / 2.0))
            kx, ky = k * np.cos(th), k * np.sin(th)
            phase = rng.uniform(0.0, 2 * np.pi, num_components)
        return FourierTerrain(
            _h0=float(height),
            _amp=tuple(amp.tolist()),
            _kx=tuple(kx.tolist()),
            _ky=tuple(ky.tolist()),
            _phase=tuple(phase.tolist()),
        )

    def spectrum(self) -> np.ndarray:
        """(4, K) rows ``amp, kx, ky, phase``."""
        return np.stack([np.asarray(self._amp), np.asarray(self._kx), np.asarray(self._ky), np.asarray(self._phase)])

    def _args(self, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        spec = torch.as_tensor(self.spectrum(), dtype=x.dtype, device=x.device)
        amp, kx, ky, phase = spec
        return amp, kx, ky, x[..., None] * kx + y[..., None] * ky + phase

    def height(self, x, y):
        amp, _, _, arg = self._args(x, y)
        return self._h0 + (amp * torch.sin(arg)).sum(-1)

    def normal(self, x, y):
        """The analytic outward unit normal (the exact gradient)."""
        amp, kx, ky, arg = self._args(x, y)
        c = torch.cos(arg)
        dhdx = (amp * kx * c).sum(-1)
        dhdy = (amp * ky * c).sum(-1)
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
