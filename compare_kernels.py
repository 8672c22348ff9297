"""Time the port's backward-blend kernel against other versions of its
source, at chip_smoke.py's garden shapes, on one GPU.

    python3 compare_kernels.py NAME=DIR [NAME=DIR ...]

Each DIR holds another version of ``rasterize_backward.cu`` with the
``blend_pair.cuh`` it includes, for example the parent commit's, written
out with ``git show HEAD~1:tpusplat_torch/csrc/rasterize_backward.cu``; it
must keep the tree's C interface (``tpusplat_backward``). No such version
stays in the tree. Each is built with nvcc (the ptxas report is printed),
checked against the tree's kernel on the same inputs (rows normalised by
their largest magnitude, atol 1e-4) and timed with CUDA events, mean of 20
calls after a warm call, in turns: the tree's kernel, each version, each
version again in reverse order, the tree's again. One JSON line per phase;
the last is the summary, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "compare_kernels"


def log(**kw):
    print(json.dumps(kw), flush=True)


def build_versions(versions: dict[str, pathlib.Path]):
    """{name: the version's ``tpusplat_backward``}, one nvcc for each
    version, all started together."""
    from tpusplat_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src_dir in versions.items():
        src, lib = src_dir / "rasterize_backward.cu", OUT / f"{name}-rasterize_backward.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src_dir),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, src)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fns = {}
    for name, (proc, lib, src) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"compare_kernels: nvcc failed for {src}:\n{text}")
        ptxas = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(phase="build", version=name, ptxas=ptxas)
        fn = ctypes.CDLL(str(lib)).tpusplat_backward
        fn.argtypes = [p, ll, p, p, i, i, i, i, i, i, i, f, f, f, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv) -> int:
    import torch

    from tpusplat_torch.ops import _build, binning, rasterize
    from tpusplat_torch.ops.preprocess import preprocess

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    versions = {k: pathlib.Path(v).resolve() for k, v in (a.split("=", 1) for a in argv)}
    if not versions:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    log(phase="device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    _build.build()
    fns = build_versions(versions)

    params, cams, cfg = cs.garden_inputs(torch, dev)
    cam, w, h = cams[0], cams[0].width, cams[0].height
    stream = _build.stream_ptr(dev)
    with torch.no_grad():
        pg = preprocess(params, cam, cfg)
        binned = binning.bin_and_sort(pg, w, h, cfg)
        if int(binned.overflow):
            raise SystemExit("compare_kernels: capacity overflow")
        attr = rasterize.pack_instances(pg, binned)
        starts, ends = binned.tile_start, binned.tile_end
        live = int(binned.num_instances)
        tiles_x, _ = cfg.tile_grid(w, h)
        img, tmap, _ = rasterize.forward_blend(attr, starts, ends, tiles_x, 0, w, h, cfg)
        d_img, d_tmap = cs.seeded_cotangents(torch, img, tmap, seed=2)
        bw_args = (attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, 0, w, h, cfg)

        def run(name):
            if name == "tree":
                return rasterize.backward_blend(*bw_args)
            out = torch.empty_like(attr)
            _build.check(fns[name](
                attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(),
                starts.shape[0], tiles_x, cfg.tile_w, cfg.tile_h, 0, w, h, cfg.alpha_max,
                cfg.alpha_min, cfg.t_min, img.data_ptr(), tmap.data_ptr(), d_img.data_ptr(),
                d_tmap.data_ptr(), out.data_ptr(), stream), f"{name} backward")
            return out

        want = run("tree")
        for name in fns:
            err = cs.check_rows(f"{name} backward", run(name)[:, :live], want[:, :live])
            log(phase="check", version=name, max_err=err)

        turns = []
        for name in ["tree", *versions, *reversed(versions), "tree"]:
            turns.append(dict(version=name,
                              backward_ms=cs.cuda_ms(torch, lambda: run(name), reps=20)))
            log(phase="turn", **turns[-1])
    log(phase="summary", nvidia_smi=smi, num_instances=live, turns=turns)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
