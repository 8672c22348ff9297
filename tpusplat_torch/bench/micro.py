"""Microbenchmarks of the PyTorch primitives the binning and gradient plumbing
are built from (counterpart of ``tpusplat/bench/micro.py``), at production
scale: C = 5,603,328 instance slots, N = 1.4M Gaussians, T = 8160 tiles.

  * 1-D and row gathers (the emission and pack primitives);
  * unique-index scatters;
  * ``torch.sort`` with 1, 2 or 3 operands, stable or not, and on
    presorted keys; ``argsort``; ``cumsum`` and ``cummax``;
  * transposes of the [16, C] slab and a 10-op elementwise chain.

These are library calls by design: the module measures primitives, not a
kernel of the port. Index tensors are int64 where PyTorch indexes with
them, int32 where the JAX bench's were data.

    python -m tpusplat_torch.bench.micro
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusplat_torch.bench._timing import clock, emit, require_card, time_ms

C = 5_603_328  # garden capacity (instance slots)
N = 1_400_000
T = 8160  # tiles at 1080p


def _gather_payload(key, *payloads, stable=True):
    keys, perm = torch.sort(key, stable=stable)
    return (keys, *(p[perm] for p in payloads))


def run(device="cuda", c: int = C, n: int = N, t: int = T, reps: int = 5) -> dict:
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.tensor(a, device=device)

    perm = dev(rng.permutation(c))  # int64
    perm_i32 = perm.to(torch.int32)
    idx_n = dev(rng.integers(0, n, size=c))
    tile_key = dev(np.sort(rng.integers(0, t, size=c)).astype(np.int32))
    tile_rand = dev(rng.integers(0, t, size=c).astype(np.int32))
    vals_c = dev(rng.uniform(size=c).astype(np.float32))
    table16 = dev(rng.uniform(size=(n, 16)).astype(np.float32))
    table8 = table16[:, :8].contiguous()
    table6 = dev(rng.uniform(size=(n, 6)).astype(np.float32))
    depth = dev(rng.uniform(size=n).astype(np.float32))
    slots = torch.arange(c, dtype=torch.int32, device=device)
    slab = dev(rng.uniform(size=(16, c)).astype(np.float32))
    rows16 = dev(rng.uniform(size=(c, 16)).astype(np.float32))
    off_n = dev(np.sort(rng.integers(0, c, size=n)))
    marks = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    f32, i32 = torch.float32, torch.int32

    cases = {
        "gather_1d_C_from_C": lambda: vals_c[perm],
        "gather_1d_C_from_N": lambda: depth[idx_n],
        "gather_rows_C_16": lambda: table16[idx_n],
        "gather_rows_C_8": lambda: table8[idx_n],
        "scatter_unique_C": lambda: torch.zeros(c, dtype=f32, device=device).index_copy_(
            0, perm, vals_c),
        "scatter_unique_C_i32": lambda: torch.zeros(c, dtype=i32, device=device).index_copy_(
            0, perm, slots),
        "cumsum_C": lambda: torch.cumsum(vals_c, 0),
        "sort_C_1key_1payload": lambda: _gather_payload(tile_rand, slots),
        "sort_C_1key_2payload": lambda: _gather_payload(tile_rand, idx_n, slots),
        "sort_C_2keys": lambda: torch.sort((tile_rand.long() << 32) | slots.long()),
        "sort_C_1key_nonstable": lambda: _gather_payload(tile_rand, slots, stable=False),
        "argsort_N_f32_stable": lambda: torch.argsort(depth, stable=True),
        "argsort_C_i32": lambda: torch.argsort(perm_i32),
        "sort_presorted_C": lambda: _gather_payload(tile_key, slots),
        "scatter_iota_C": lambda: torch.zeros(c, dtype=i32, device=device).index_copy_(
            0, perm, slots),
        "scatter_marks_N_into_C": lambda: torch.zeros(c, dtype=i32, device=device)
        .scatter_reduce_(0, off_n, marks, "amax"),
        "cummax_C": lambda: torch.cummax(perm_i32, 0),
        "cumsum_C_i32": lambda: torch.cumsum(perm_i32, 0, dtype=i32),
        "gather_rows_C6_from_N": lambda: table6[idx_n],
        "transpose_16C_to_C16": lambda: slab.t().contiguous(),
        "transpose_C16_to_16C": lambda: rows16.t().contiguous(),
        "scatter_rows_C16": lambda: torch.zeros((c, 16), dtype=f32, device=device)
        .index_copy_(0, perm, rows16),
        "gather_rows_C16_from_C": lambda: rows16[perm],
        "elementwise_10op_C": lambda: ((vals_c * 2 + 1) * vals_c - 3) * (vals_c + 0.5)
        * (vals_c - 0.25) + vals_c * vals_c,
    }
    r = {name: time_ms(fn, device, reps)[0] for name, fn in cases.items()}
    return dict(clock=clock(device), C=c, N=n, T=t, ms=r)


def main(argv=None) -> int:
    if not require_card("micro"):
        return 1
    res = run()
    w = max(len(k) for k in res["ms"])
    for k, v in res["ms"].items():
        print(f"{k:<{w}} {v:10.3f} ms", file=sys.stderr)
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
