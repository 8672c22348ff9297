"""Drive one ``train_grow`` cell through the harness on the CPU, with a
fault optionally planted in the port, and print the result line. The
harness's own tests run it in a temporary copy of the benchmark that holds
a tiny cell.

    python3 rehearse_grow.py ROOT WORKLOAD SEED SECONDS TRACE [FAULT]

FAULT, planted where the port produces its answer: in
``tpusplat_torch.train.densify.densify_and_prune`` (which the compiled
round looks up at each call) ``unchanged`` (the round returns its state),
``clone_only`` (every candidate clones), ``moments_kept`` (no moment is
zeroed), ``noise_zero`` (both split draws 0); in
``tpusplat_torch.train.step.apply_gradients`` ``no_stats`` (the densify
statistics never accumulate).
"""

import dataclasses
import json
import sys

root, workload, seed, seconds, traced = sys.argv[1:6]
fault = sys.argv[6] if len(sys.argv) > 6 else None
sys.path.insert(0, root)

import torch  # noqa: E402

torch.set_num_threads(1)


def patch(fault):
    import tpusplat_torch.train.densify as densify
    import tpusplat_torch.train.step as step

    real_round, real_apply = densify.densify_and_prune, step.apply_gradients
    if fault == "no_stats":
        def apply_gradients(state, *a, **k):
            new, metrics = real_apply(state, *a, **k)
            return dataclasses.replace(new, grad_accum=state.grad_accum,
                                       grad_count=state.grad_count,
                                       max_radii=state.max_radii), metrics

        step.apply_gradients = apply_gradients
        return

    def densify_and_prune(state, key, dcfg, scene_extent, noise=None, noise2=None):
        if fault == "unchanged":
            return state
        if fault == "clone_only":
            dcfg = dataclasses.replace(dcfg, percent_dense=1e9)
        if fault == "noise_zero":
            n = state.params.num_gaussians
            noise = noise2 = torch.zeros((n, 3), device=state.params.device)
        out = real_round(state, key, dcfg, scene_extent, noise, noise2)
        if fault == "moments_kept":
            out = dataclasses.replace(out, mu=state.mu, nu=state.nu)
        return out

    if fault not in ("unchanged", "clone_only", "noise_zero", "moments_kept"):
        raise SystemExit(f"unknown fault {fault!r}")
    densify.densify_and_prune = densify_and_prune


if fault:
    patch(fault)

from splatbench import run  # noqa: E402

out = run.execute(workload, int(seed), float(seconds), bool(int(traced)), device="cpu")
print(json.dumps(out))
