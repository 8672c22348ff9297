"""Drive one ``train_2dgs`` cell through the harness on the CPU (the port's
plain surfel path), with a fault optionally planted in the port, and print
the result line. The harness's own tests run it in a temporary copy of the
benchmark that holds a tiny cell.

    python3 rehearse_2dgs.py ROOT WORKLOAD SEED SECONDS TRACE [FAULT]

FAULT, planted in ``tpusplat_torch.ops.surfel`` where the port produces its
answer (``reference_2dgs.FAULTS``' counterparts): ``no_filter`` (the
low-pass filter's rho2 pushed out of reach, so G follows the disk alone),
``no_flip`` (the table's normals replaced by R_cw t_w as it comes),
``centre_depth`` (each pair's depth the surfel centre's), ``drop_am2``
(the distortion without its A m^2 term).
"""

import json
import sys

root, workload, seed, seconds, traced = sys.argv[1:6]
fault = sys.argv[6] if len(sys.argv) > 6 else None
sys.path.insert(0, root)

import torch  # noqa: E402

torch.set_num_threads(1)


def patch(fault):
    from tpusplat_torch.ops import surfel
    from tpusplat_torch.ops.preprocess import quat_to_rotmat_cols

    if fault == "no_filter":
        surfel.FILTER_INV_SQ = 1e30
    elif fault == "centre_depth":
        real_terms = surfel.pair_terms

        def pair_terms(a, px, py, rays, near):
            u, v, rho3, rho2, z, ok = real_terms(a, px, py, rays, near)
            zc = a[surfel.S_TW + 2].expand_as(z)
            return u, v, rho3, rho2, zc, ok & (zc >= near)

        surfel.pair_terms = pair_terms
    elif fault == "drop_am2":
        def distortion(w, m, a_before, m1_before, m2_before):
            return (w * (-2.0 * m * m1_before + m2_before)).sum(1)

        surfel.distortion = distortion
    elif fault == "no_flip":
        real_pre = surfel.preprocess2d_plain

        def preprocess2d_plain(params, camera, cfg):
            ps = real_pre(params, camera, cfg)
            q = params.quats
            r = quat_to_rotmat_cols(q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12))
            v = camera.view
            n = torch.stack([v[i, 0] * r[2] + v[i, 1] * r[5] + v[i, 2] * r[8] for i in range(3)])
            ps.table = torch.cat([ps.table[:surfel.S_N], n])
            return ps

        surfel.preprocess2d_plain = preprocess2d_plain
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if fault:
    patch(fault)

from splatbench import run  # noqa: E402

out = run.execute(workload, int(seed), float(seconds), bool(int(traced)), device="cpu")
print(json.dumps(out))
