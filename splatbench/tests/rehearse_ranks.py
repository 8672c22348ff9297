"""Drive a cell of several cards through the harness's ranks, on the CPU
(gloo) or with every rank on one card (gloo), with the timed path
optionally broken underneath in every rank, and print the result line.
The harness's own tests run it in a temporary copy of the benchmark that
holds a tiny cell.

    python3 rehearse_ranks.py ROOT WORKLOAD SEED SECONDS TRACE DEVICE [FAULT]

DEVICE is ``cpu`` or ``cuda:0``. FAULT breaks the port's sharded step:
``unchanged`` (the step returns its state as it was), ``half_batch`` (each
strip's loss over the left half of the image alone), ``altered`` (0.1
added to the first tile of the image the loss sees), ``strip_lost``
(the second strip's gradient lost, its loss unchanged), ``halo_cut`` (no
halo rows exchanged between strips), ``raise`` (rank 2 raises in set-up).
"""

import json
import sys


def patch(rank, fault):
    import torch
    import torch.nn.functional as F

    from tpusplat_torch.parallel import sharded

    if fault == "unchanged":
        real_update = sharded._gated_update

        def gated_update(state, *a, **k):
            return state, real_update(state, *a, **k)[1]

        sharded._gated_update = gated_update
    elif fault in ("half_batch", "altered", "strip_lost"):
        real_loss = sharded._strip_loss_local

        def strip_loss(strips, targets, row0_px, total_rows_px, height, width, w, mesh):
            if fault == "half_batch":
                width //= 2
                targets = targets[:, :, :width]
            elif fault == "altered" and mesh.t == 0:
                strips = strips + F.pad(torch.full((16, 16, 3), 0.1, device=strips.device),
                                        (0, 0, 0, strips.shape[2] - 16, 0, strips.shape[1] - 16))
            elif fault == "strip_lost" and mesh.t == 1:
                strips = strips.detach() + 0.0 * strips  # the value kept, the gradient lost
            return real_loss(strips, targets, row0_px, total_rows_px, height, width, w, mesh)

        sharded._strip_loss_local = strip_loss
    elif fault == "halo_cut":
        def halo_exchange(img, group, rows):
            zero = img.new_zeros((img.shape[0], rows, *img.shape[2:]))
            return zero, zero

        sharded.halo_exchange = halo_exchange
    elif fault == "raise":
        if rank == 2:
            def shard_state(*a, **k):
                raise RuntimeError("a rank planted to fail in set-up")

            sharded.shard_state = shard_state
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    root, workload, seed, seconds, traced, device = sys.argv[1:7]
    fault = sys.argv[7] if len(sys.argv) > 7 else None
    sys.path.insert(0, root)

    import torch

    torch.set_num_threads(1)

    from splatbench import ranks

    out = ranks.execute(workload, int(seed), float(seconds), bool(int(traced)), device=device,
                        hook=(patch, fault) if fault else None)
    print(json.dumps(out))
