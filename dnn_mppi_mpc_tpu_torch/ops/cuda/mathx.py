"""The (seed, block) → N(0, 1) hash stream, plain PyTorch version.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/mathx.py:86 _splitmix32`` and
``:96 hash_normal_pair``; the device version is ``csrc/hash_normal.cuh``,
which the tick kernels call. uint32 values are held in int64 tensors: every
32-bit multiply is split into 16-bit halves so no int64 product overflows,
and the result is masked to 32 bits, which reproduces uint32 wraparound
exactly.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for x in [0, 2³²) held as int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix-style uint32 finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_bits(seed, block_id, shape, device=None):
    """The two uint32 words (as int64) behind each normal pair.

    ``seed`` and ``block_id`` are ints or int64 tensors holding uint32 values
    (``block_id`` may have a batch shape B); ``shape`` is (T, R, 128) as in the
    JAX package. Returns two int64 tensors of shape B + shape."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    block = torch.as_tensor(block_id, dtype=torch.int64, device=seed.device) & _M32
    base = splitmix32(_mul32(seed, 0x9E3779B9) ^ splitmix32((block + 0x85EBCA6B) & _M32))
    base = base.reshape(base.shape + (1,) * len(shape))
    ctr = torch.arange(math.prod(shape), dtype=torch.int64, device=seed.device).reshape(shape)
    bits1 = splitmix32(base ^ _mul32(ctr, 0x9E3779B1))
    bits2 = splitmix32(base ^ ((_mul32(ctr, 0xC2B2AE35) + 0x1234567) & _M32))
    return bits1, bits2


def hash_normal_pair(seed, block_id, shape, device=None):
    """Two float32 N(0, 1) tensors, a pure function of (seed, block,
    position): Box-Muller on the top 24 bits of :func:`hash_bits`."""
    bits1, bits2 = hash_bits(seed, block_id, shape, device)
    scale = 1.0 / 16777216.0
    u1 = 1.0 - (bits1 >> 8).to(torch.float32) * scale
    u2 = (bits2 >> 8).to(torch.float32) * scale
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = u2 * torch.tensor(2.0 * math.pi, dtype=torch.float32)
    return rad * torch.cos(ang), rad * torch.sin(ang)


def hash_noise(seed, chol: torch.Tensor, K: int, T: int, k_blk: int, block_offset: int = 0,
               *, per_member: bool = False) -> torch.Tensor:
    """ε (K, T, nu) colored by the (nu, nu) lower Cholesky factor ``chol``:
    normal pair p of sample k = b·k_blk + r·128 + lane at step t takes
    position (p·T + t, r, lane) of ``hash_normal_pair(seed, block_offset + b,
    (P·T, k_blk/128, 128))``, P = ⌈nu/2⌉, i.e. counter (p·T + t)·k_blk + local
    of the (seed, block) stream (the K-blocked tick's stream contract; the
    single-block tick is k_blk = K, a shard of the sample-sharded tick starts
    at its global ``block_offset``). For nu = 2 this is the one pair per step
    of the diff-drive ticks; for odd nu the second normal of the last pair is
    dropped. Coloring runs left to right, ε_j = L[j,0]·z_0 + L[j,1]·z_1 + …,
    as ``dmm_color`` in csrc/hash_normal.cuh.

    ``per_member``: ``seed`` is a (B,) vector of fleet seeds and the result
    (B, K, T, nu), member b drawing from ``seed[b]`` (the fleet tick)."""
    if K % k_blk or k_blk % 128:
        raise ValueError(f"need K % k_blk == 0 and k_blk % 128 == 0 (K={K}, k_blk={k_blk})")
    nu = chol.shape[-1]
    P = (nu + 1) // 2
    seed = torch.as_tensor(seed, dtype=torch.int64, device=chol.device)
    seed = seed.reshape(-1, 1) if per_member else seed.reshape(())
    blocks = torch.arange(K // k_blk, dtype=torch.int64, device=chol.device) + block_offset
    z0, z1 = hash_normal_pair(seed, blocks, (P * T, k_blk // 128, 128), device=chol.device)
    # (..., NB, P·T, R, 128) → P tensors of (..., K, T) per member of the pair
    lead = z0.shape[:-4]
    z = []
    for zz in (z0, z1):
        zz = zz.reshape(lead + (-1, P, T, k_blk)).transpose(-1, -2)  # (..., NB, P, k_blk, T)
        z.append([zz[..., p, :, :].reshape(lead + (K, T)) for p in range(P)])
    z = [z[h][p] for p in range(P) for h in (0, 1)][:nu]  # z_0, z_1, ... in pair order
    eps = []
    for j in range(nu):
        acc = chol[j, 0] * z[0]
        for i in range(1, j + 1):
            acc = acc + chol[j, i] * z[i]
        eps.append(acc)
    return torch.stack(eps, dim=-1)


__all__ = ["splitmix32", "hash_bits", "hash_normal_pair", "hash_noise"]
