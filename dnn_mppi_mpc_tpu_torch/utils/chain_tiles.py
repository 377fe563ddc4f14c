"""Fit the ResNet chain's tile plan to the card.

``ops/cuda/dense_chain.py`` picks each layer's output tile from a cost
model: a fixed cost a tile plus a cost a 64-deep chunk for each tile shape
(``TILE_US``, ``CHUNK_US``). This script measures where those numbers come
from: every distinct (c_out, c_in) layer shape of ResNet-50 (and -18) at
B = 1 024, run as the head of a two-phase program (a stem 5 → c_in, then the
layer), under every tile the kernel has, device time from the profiler; then
a least-squares fit of one offset a shape (the stem and the launch), the
fixed cost and the chunk costs. Needs a CUDA card:

    python -m dnn_mppi_mpc_tpu_torch.utils.chain_tiles [--calls 20]

It prints one JSON line per measurement and one with the fit, and exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .._build import launch
from ..models.learned import ResNet1D, fold_resnet1d_l1_arrays
from ..ops.cuda import dense_chain as dc

B = 1024


def kernel_us(fn, calls: int) -> float:
    """Device µs a call of the chain kernel launched by ``fn``, from the
    profiler (a few sleep kernels first: CUPTI can miss a profile's first
    records)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(200_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "resnet_chain" in e.name]
    if not times:
        raise RuntimeError("the profiler recorded no chain kernel")
    return sum(times) / len(times)


def layer_shapes() -> list:
    """The distinct (n_pad, k_pad) of ResNet-18's and ResNet-50's layers but
    the stems."""
    shapes = set()
    for variant in ("18", "50"):
        net = ResNet1D(3, variant, device="cpu")
        chain = dc.pack_resnet_chain(*fold_resnet1d_l1_arrays(net), device="cpu")
        shapes |= {tuple(w.shape) for w in chain.packed[1:]}
    return sorted(shapes)


def measure(dev, calls: int) -> list:
    """[(n_pad, k_pad, bm, bn, µs)] over every layer shape and tile."""
    g = torch.Generator().manual_seed(0)
    grid = dc._grid(dev.index)
    x = torch.randn(B, 5, generator=g).to(dev)
    rows = []
    for n_pad, k_pad in layer_shapes():
        stem = (torch.randn(5, k_pad, generator=g), 0.1 * torch.randn(k_pad, generator=g))
        head = (torch.randn(k_pad, n_pad, generator=g) / k_pad ** 0.5,
                0.1 * torch.randn(n_pad, generator=g))
        chain = dc.pack_resnet_chain(stem, [], head, dev)
        base, offsets, nbytes = dc._call_args(chain, B, grid)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        out = torch.empty((B, n_pad), device=dev)
        want = dc.resnet_chain_plain(x, chain)
        for bm, bn in dc.TILES:
            if n_pad % bn:
                continue
            args = dc.DmmChainArgs.from_buffer_copy(base)
            args.x, args.out, args.B = x.data_ptr(), out.data_ptr(), B
            args.h, args.r, args.y0, args.y1 = (scratch.data_ptr() + offsets[k]
                                                for k in ("h", "r", "y0", "y1"))
            args.bm[1], args.bn[1] = bm, bn
            us = kernel_us(lambda: launch("dmm_resnet_chain", args, dev), calls)
            err = float((out - want).abs().max())
            rows.append((n_pad, k_pad, bm, bn, us))
            print(json.dumps({"n_pad": n_pad, "k_pad": k_pad, "tile": [bm, bn], "us": us,
                              "max_abs_err": err}), flush=True)
    return rows


def fit(rows: list, grid: int) -> dict:
    """Least squares: µs = offset[shape] + waves·(TILE_US + chunks·CHUNK_US[tile])."""
    shapes = sorted({(n, k) for n, k, *_ in rows})
    tiles = list(dc.TILES)
    A = np.zeros((len(rows), len(shapes) + 1 + len(tiles)))
    y = np.zeros(len(rows))
    for i, (n, k, bm, bn, us) in enumerate(rows):
        waves = -(-(B // bm) * (n // bn) // grid)
        A[i, shapes.index((n, k))] = 1.0
        A[i, len(shapes)] = waves
        A[i, len(shapes) + 1 + tiles.index((bm, bn))] = waves * -(-k // dc.BK)
        y[i] = us
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return {"TILE_US": float(sol[len(shapes)]),
            "CHUNK_US": {f"{bm}x{bn}": float(c) for (bm, bn), c in
                         zip(tiles, sol[len(shapes) + 1:])},
            "rms_us": float(np.sqrt(np.mean((A @ sol - y) ** 2)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20, help="profiled calls a measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = measure(dev, args.calls)
    print(json.dumps({"fit": fit(rows, dc._grid(dev.index)), "B": B,
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
