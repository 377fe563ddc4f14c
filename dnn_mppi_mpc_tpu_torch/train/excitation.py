"""System-identification excitation signals and space-filling sampling —
counterpart of ``dnn_mppi_mpc_tpu/train/excitation.py``.

* :func:`step_sequence`, :func:`ramp_sequence`, :func:`sine_sequence` —
  deterministic (T, dim) input sequences at a fixed rate;
* :func:`random_sequence` — uniform random inputs with a zero-order hold;
* :func:`multisine_sequence` — a smooth sum of sines with random
  amplitudes, frequencies and phases (persistent excitation);
* :func:`latin_hypercube` — one sample per stratum in each dimension.

Where the JAX functions take a PRNG key, these take a ``torch.Generator``
on ``device`` and advance it. The JAX functions draw one sequence per key
and ``vmap`` over keys for a fleet; :func:`random_sequence` and
:func:`multisine_sequence` take ``batch`` instead and return (batch, T, dim)
sequences drawn in one call. Every function returns float32 tensors on
``device``, the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import resolve_device


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _shape(batch: Optional[int], *dims: int) -> tuple:
    return dims if batch is None else (batch,) + dims


def step_sequence(num_steps: int, amplitudes, period: int, *, device="cuda") -> torch.Tensor:
    """Square wave: +amplitude for ``period`` ticks, then −amplitude, and so
    on. (T, dim)."""
    device = resolve_device(device)
    t = torch.arange(num_steps, device=device)
    sign = torch.where((t // period) % 2 == 0, 1.0, -1.0)
    return sign[:, None] * _f32(amplitudes, device)[None, :]


def ramp_sequence(num_steps: int, slopes, u_max, *, device="cuda") -> torch.Tensor:
    """t·slope clipped to ±u_max. (T, dim)."""
    device = resolve_device(device)
    t = torch.arange(num_steps, dtype=torch.float32, device=device)[:, None]
    u_max = _f32(u_max, device)
    return torch.clamp(t * _f32(slopes, device)[None, :], -u_max, u_max)


def sine_sequence(num_steps: int, amplitudes, freqs_hz, dt: float, *,
                  device="cuda") -> torch.Tensor:
    """amplitude·sin(2π·f·t) at t = k·dt. (T, dim)."""
    device = resolve_device(device)
    t = torch.arange(num_steps, dtype=torch.float32, device=device)[:, None] * dt
    return _f32(amplitudes, device)[None, :] * torch.sin(
        2.0 * math.pi * _f32(freqs_hz, device)[None, :] * t)


def random_sequence(generator: torch.Generator, num_steps: int, u_min, u_max, hold: int = 1,
                    *, batch: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Uniform draws in [u_min, u_max), each held for ``hold`` ticks. (T,
    dim), or (batch, T, dim) with ``batch``."""
    device = resolve_device(device)
    u_min, u_max = _f32(u_min, device), _f32(u_max, device)
    n = -(-num_steps // hold)
    u = torch.rand(_shape(batch, n, u_min.shape[0]), generator=generator, device=device)
    u = u_min + u * (u_max - u_min)
    return torch.repeat_interleave(u, hold, dim=-2)[..., :num_steps, :]


def multisine_sequence(generator: torch.Generator, num_steps: int, dim_u: int,
                       amp_range=(0.3, 1.5), freq_range=(0.2, 1.0), n_tones: int = 3, *,
                       batch: Optional[int] = None, device="cuda") -> torch.Tensor:
    """The mean of ``n_tones`` sines a dimension, each with an amplitude
    from ``amp_range``, a frequency (rad per tick) from ``freq_range`` and a
    phase from [0, 2π). (T, dim_u), or (batch, T, dim_u) with ``batch``."""
    device = resolve_device(device)

    def uniform(lo, hi):
        u = torch.rand(_shape(batch, 1, n_tones, dim_u), generator=generator, device=device)
        return lo + u * (hi - lo)

    amps, freqs = uniform(*amp_range), uniform(*freq_range)
    phases = uniform(0.0, 2.0 * math.pi)
    t = torch.arange(num_steps, dtype=torch.float32, device=device)[:, None, None]
    return torch.sum(amps * torch.sin(freqs * t + phases), dim=-2) / n_tones


def latin_hypercube(generator: torch.Generator, n_samples: int, bounds, *,
                    device="cuda") -> torch.Tensor:
    """``n_samples`` points in the box ``bounds`` ((dim, 2): low, high):
    each dimension cut into ``n_samples`` strata, one uniform draw in each,
    the strata's order permuted independently per dimension. (n, dim)."""
    device = resolve_device(device)
    bounds = _f32(bounds, device)
    dim = bounds.shape[0]
    u = torch.rand((n_samples, dim), generator=generator, device=device)
    perms = torch.stack([torch.randperm(n_samples, generator=generator, device=device)
                         for _ in range(dim)], dim=1)
    z = (perms.to(u.dtype) + u) / n_samples
    return bounds[:, 0] + z * (bounds[:, 1] - bounds[:, 0])


__all__ = [
    "latin_hypercube",
    "multisine_sequence",
    "ramp_sequence",
    "random_sequence",
    "sine_sequence",
    "step_sequence",
]
