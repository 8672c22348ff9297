"""Time one of the port's kernels against other versions of its source, at
chip_smoke.py's garden shapes, on one GPU.

    python3 compare_kernels.py KERNEL NAME=DIR [NAME=DIR ...]

KERNEL is ``forward`` (``rasterize_forward.cu``), ``backward``
(``rasterize_backward.cu``) or ``emission`` (``emission.cu``). Each DIR holds
another version of that source with the headers it includes, for example
the parent commit's, written out with ``git show
HEAD~1:tpusplat_torch/csrc/<source>`` (and ``blend_pair.cuh``,
``cull.cuh`` where it includes them). No such version stays in the tree.
Each is built with nvcc (the ptxas report is printed, and whether its
machine code equals the tree's, where ``cuobjdump`` is there; a version
that does not build is reported and left out), checked
against the tree's kernel on the same inputs and timed with CUDA events
in turns: the tree's kernel, each version, each version again in reverse
order, the tree's again.

- forward: a version keeps the tree's C interface (``tpusplat_forward``);
  its image and T must be bit-equal to the tree's.
- backward: a version keeps ``tpusplat_backward``; its rows are held to
  the tree's normalised by their largest magnitude (atol 1e-4), and
  whether they are bit-equal is printed.
- emission: a version keeps ``tpusplat_emit``; its tile, gid and
  counters must be bit-equal to the tree's. Each is timed twice: the C
  call alone on inputs made beforehand (``kernel_ms``), and the whole call
  with its allocations as the tree's wrapper makes it (``call_ms``); and,
  where ``torch.profiler`` sees device time, the device time of each
  kernel by name.

One JSON line per phase; the last is the summary, with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "compare_kernels"
SOURCES = dict(forward="rasterize_forward", backward="rasterize_backward",
               emission="emission")
p_, i_, f_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = dict(
    tpusplat_forward=[p_, ll_, p_, p_, i_, i_, i_, i_, i_, i_, i_, f_, f_, f_, p_, p_, p_],
    tpusplat_backward=[p_, ll_, p_, p_, i_, i_, i_, i_, i_, i_, i_, f_, f_, f_,
                       p_, p_, p_, p_, p_, p_],
    tpusplat_emit=[p_, p_, p_, p_, p_, i_, p_, i_, i_, i_, i_, p_, p_, p_, p_, p_, p_],
)
ENTRY = dict(forward="tpusplat_forward", backward="tpusplat_backward",
             emission="tpusplat_emit")


def log(**kw):
    print(json.dumps(kw), flush=True)


def sass(lib: pathlib.Path):
    """The library's machine code without addresses, or None where
    ``cuobjdump`` is missing."""
    from tpusplat_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(pathlib.Path(_build.nvcc()).with_name("cuobjdump"))
    if not pathlib.Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip() for ln in text.splitlines()
            if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]


def build_versions(kernel: str, versions: dict[str, pathlib.Path]):
    """{name: the version's C function}, one nvcc for each
    version, all started together."""
    from tpusplat_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    source = SOURCES[kernel]
    tree_sass = sass(_build.library_path(source))
    procs = {}
    for name, src_dir in versions.items():
        src, lib = src_dir / f"{source}.cu", OUT / f"{name}-{source}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src_dir),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, src)
    fns = {}
    for name, (proc, lib, src) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            log(phase="build", version=name, failed=text[-2000:])
            continue
        ptxas = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        code = sass(lib)
        cdll, entry = ctypes.CDLL(str(lib)), ENTRY[kernel]
        if not hasattr(cdll, entry):
            raise SystemExit(f"compare_kernels: {src} does not export {entry}")
        log(phase="build", version=name, ptxas=ptxas,
            sass_equal_to_tree=None if code is None or tree_sass is None else code == tree_sass)
        fn = getattr(cdll, entry)
        fn.argtypes = SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def in_turns(torch, versions, runners, reps):
    """Each runner timed in turns (tree, versions, versions reversed, tree);
    runners[name] is {label: fn}."""
    turns = []
    for name in ["tree", *versions, *reversed(versions), "tree"]:
        turns.append(dict(version=name, **{f"{label}_ms": cs.cuda_ms(torch, fn, reps=reps)
                                           for label, fn in runners[name].items()}))
        log(phase="turn", **turns[-1])
    return turns


def garden_slab(torch, dev):
    """The garden inputs of the blend kernels: (attr, starts, ends, tiles_x,
    w, h, cfg, live instances)."""
    from tpusplat_torch.ops import binning, rasterize
    from tpusplat_torch.ops.preprocess import preprocess

    params, cams, cfg = cs.garden_inputs(torch, dev)
    cam, w, h = cams[0], cams[0].width, cams[0].height
    pg = preprocess(params, cam, cfg)
    binned = binning.bin_and_sort(pg, w, h, cfg)
    if int(binned.overflow):
        raise SystemExit("compare_kernels: capacity overflow")
    attr = rasterize.pack_instances(pg, binned)
    tiles_x, _ = cfg.tile_grid(w, h)
    return (attr, binned.tile_start, binned.tile_end, tiles_x, w, h, cfg,
            int(binned.num_instances))


def compare_forward(torch, dev, fns, versions):
    from tpusplat_torch.ops import _build, rasterize

    attr, starts, ends, tiles_x, w, h, cfg, live = garden_slab(torch, dev)
    stream = _build.stream_ptr(dev)
    fw_args = (attr, starts, ends, tiles_x, 0, w, h, cfg)

    def run(name):
        if name == "tree":
            return rasterize.forward_blend(*fw_args)[:2]
        img = torch.empty((h, w, 3), device=dev)
        tmap = torch.empty((h, w), device=dev)
        _build.check(fns[name](
            attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(),
            starts.shape[0], tiles_x, cfg.tile_w, cfg.tile_h, 0, w, h, cfg.alpha_max,
            cfg.alpha_min, cfg.t_min, img.data_ptr(), tmap.data_ptr(), stream),
            f"{name} forward")
        return img, tmap

    want = run("tree")
    for name in fns:
        got = run(name)
        cs.check_equal(f"{name} forward image", got[0], want[0])
        cs.check_equal(f"{name} forward transmittance", got[1], want[1])
        log(phase="check", version=name, image="bit-equal", transmittance="bit-equal")
    turns = in_turns(torch, versions, {k: {"forward": (lambda k=k: run(k))}
                                       for k in ["tree", *fns]}, reps=20)
    return dict(num_instances=live, turns=turns)


def compare_backward(torch, dev, fns, versions):
    from tpusplat_torch.ops import _build, rasterize

    attr, starts, ends, tiles_x, w, h, cfg, live = garden_slab(torch, dev)
    stream = _build.stream_ptr(dev)
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
        got = run(name)
        err = cs.check_rows(f"{name} backward", got[:, :live], want[:, :live])
        log(phase="check", version=name, max_err=err,
            bit_equal=bool(torch.equal(got[:, :live], want[:, :live])))
    turns = in_turns(torch, versions, {k: {"backward": (lambda k=k: run(k))}
                                       for k in ["tree", *fns]}, reps=20)
    return dict(num_instances=live, turns=turns)


def compare_emission(torch, dev, fns, versions):
    from tpusplat_torch.ops import _build, binning, emission
    from tpusplat_torch.ops.preprocess import preprocess

    params, cams, cfg = cs.garden_inputs(torch, dev)
    cam = cams[0]
    n = params.num_gaussians
    tiles_x, _ = cfg.tile_grid(cam.width, cam.height)
    cap = cfg.instance_capacity(n)
    meta = binning.depth_sorted_meta(preprocess(params, cam, cfg))
    del params
    stream = _build.stream_ptr(dev)
    # Buffers made beforehand for each C call alone.
    bufs = emission.output_buffers(n, cap, dev)
    outs = {}

    def emit_into(fn, bufs):
        """A version's ``tpusplat_emit`` into ``bufs``, laid out as the
        tree's wrapper lays them out; returns what the wrapper returns."""
        small, big, c = bufs[0].data_ptr(), bufs[1].data_ptr(), emission.CHUNK_WORDS
        _build.check(fn(meta[1].data_ptr(), meta[2].data_ptr(), meta[3].data_ptr(),
                        meta[4].data_ptr(), meta[0].data_ptr(), n, None, cap, tiles_x, 0, n,
                        small, big + 8 * cap, big, big + 4 * cap, small + 4 * c, stream),
                     "tpusplat_emit")
        return (bufs[1][:cap], bufs[1][cap:2 * cap], *bufs[0][c:c + 3])

    def call(name):
        return emit_into(fns[name], emission.output_buffers(n, cap, dev))

    want = emission.emit_instances(*meta, tiles_x, cap, 0, n)
    for name in fns:
        got = call(name)
        for field, a, b in zip(("tile", "gid", "total", "overflow", "gauss_dropped"), got,
                               want):
            cs.check_equal(f"{name} emission {field}", a, b)
        log(phase="check", version=name, tile_gid_counters="bit-equal")
    runners = {"tree": dict(kernel=lambda: emission.launch(*meta, tiles_x, cap, 0, n, None,
                                                           bufs),
                            call=lambda: emission.emit_instances(*meta, tiles_x, cap, 0, n))}
    for name in fns:
        runners[name] = dict(kernel=lambda name=name: emit_into(fns[name], bufs),
                             call=lambda name=name: call(name))
    turns = in_turns(torch, versions, runners, reps=100)
    for name in ["tree", *fns]:
        outs[name] = {label: device_ms_by_name(torch, fn, reps=20)
                      for label, fn in runners[name].items()}
        log(phase="profiler", version=name, device_ms_by_kernel=outs[name])
    return dict(num_instances=int(want[2]), capacity=cap, turns=turns, profiler=outs)


def device_ms_by_name(torch, fn, reps: int):
    """{kernel name: device ms a call} under ``torch.profiler`` over
    ``reps`` calls after a warm one; empty where it sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total}


def main(argv) -> int:
    import torch

    from tpusplat_torch.ops import _build

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    if not argv or argv[0] not in SOURCES or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    kernel = argv[0]
    versions = {k: pathlib.Path(v).resolve() for k, v in (a.split("=", 1) for a in argv[1:])}
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    log(phase="device", kernel=kernel, kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    report = _build.build(verbose=True)[SOURCES[kernel]]["log"]
    log(phase="build", version="tree", ptxas=[ln.strip() for ln in report.splitlines()
                                              if "registers" in ln or "spill" in ln])
    fns = build_versions(kernel, versions)
    versions = {k: v for k, v in versions.items() if k in fns}
    compare = dict(forward=compare_forward, backward=compare_backward,
                   emission=compare_emission)[kernel]
    with torch.no_grad():
        res = compare(torch, dev, fns, versions)
    log(phase="summary", kernel=kernel, nvidia_smi=smi, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
