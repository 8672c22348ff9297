"""Permutation-plumbing bench (counterpart of ``tpusplat/bench/plumb_bench.py``):
the stages between the blends, timed alone at garden scale, each CUDA
kernel against its plain version.

  * ``emission``: the emission kernel against its plain version on the
    garden frame's depth-ordered meta; bit-equal, asserted;
  * ``gradsort``: the re-sort of the 9 gradient rows by Gaussian id (a
    torch sort and gather, no kernel of its own) on C = 4,397,056 shuffled
    ids into N = 1.4M;
  * ``segreduce``: the segment-reduce kernel against ``index_add_`` (its
    plain version) on those rows sorted; within atol 1e-4, asserted.

    python -m tpusplat_torch.bench.plumb_bench [stage ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusplat_torch.bench._timing import clock, emit, require_card, time_ms

STAGES = ("emission", "gradsort", "segreduce")
C = 4_397_056  # garden capacity (the JAX bench's)
N = 1_400_000


def run(stages=STAGES, device="cuda", conf="garden", c: int = C, n: int = N,
        reps: int = 10) -> dict:
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.rasterize import sort_grad_rows
    from tpusplat_torch.ops.segment_reduce import segment_reduce, segment_reduce_plain

    r: dict = dict(clock=clock(device))
    with torch.no_grad():
        if "emission" in stages:
            from tpusplat_torch.bench.profile_detail import scene
            from tpusplat_torch.ops.preprocess import preprocess

            params, cam, cfg = scene(conf, device)
            tiles_x, _ = cfg.tile_grid(cam.width, cam.height)
            k, cap = params.num_gaussians, cfg.instance_capacity(params.num_gaussians)
            meta = binning.depth_sorted_meta(preprocess(params, cam, cfg))
            r["expand_cuda"], got = time_ms(lambda: emit_instances(*meta, tiles_x, cap, 0, k),
                                            device, reps)
            r["expand_plain"], want = time_ms(
                lambda: binning.expand_instances_sorted(*meta, tiles_x, cap, 0, k), device,
                reps)
            for name, a, b in zip(("tile", "gid", "total", "overflow", "dropped"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"plumb_bench: emission {name} is not bit-equal to "
                                         "its plain version")
            r["expand_match"] = True
            r["instances"] = int(got[2])
        if {"gradsort", "segreduce"} & set(stages):
            rng = np.random.default_rng(0)
            gid = np.sort(rng.integers(0, n, size=c)).astype(np.int32)
            gid_s = torch.tensor(gid, device=device)
            grads = torch.tensor(rng.uniform(size=(9, c)).astype(np.float32), device=device)
            if "gradsort" in stages:
                gid_u = torch.tensor(rng.permutation(gid), device=device)
                r["grad_sort_9payload"], _ = time_ms(lambda: sort_grad_rows(grads, gid_u, n),
                                                     device, reps)
            if "segreduce" in stages:
                ids = torch.arange(n + 1, dtype=torch.int32, device=device)
                bounds = torch.searchsorted(gid_s, ids, out_int32=True)
                r["segreduce_cuda"], got = time_ms(
                    lambda: segment_reduce(grads, gid_s, bounds), device, reps)
                r["segreduce_plain"], want = time_ms(
                    lambda: segment_reduce_plain(grads, gid_s, bounds), device, reps)
                err = float((got - want).abs().max())
                if not err <= 1e-4:
                    raise AssertionError(f"plumb_bench: segment reduce off by {err} "
                                         "(atol 1e-4)")
                r["segreduce_max_abs_err"] = err
    return r


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card("plumb_bench"):
        return 1
    unknown = set(argv) - set(STAGES)
    if unknown:
        print(f"plumb_bench: unknown stages {sorted(unknown)} (of {STAGES})", file=sys.stderr)
        return 2
    res = run(tuple(argv) or STAGES)
    for k, v in res.items():
        if isinstance(v, float) and k.endswith(("cuda", "plain", "payload")):
            print(f"{k:<24} {v:9.3f} ms", file=sys.stderr)
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
