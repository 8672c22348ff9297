"""3DGS .ply scene IO (counterpart of ``tpusplat/io/ply.py``): the body is
read by the C++ reader of ``native/`` (:mod:`tpusplat_torch.io.native_loader`)
or by numpy.

The standard 3DGS layout (``src/GSScene.cpp:17-24``): 62 float32 properties
per vertex, ``x y z nx ny nz f_dc_0..2 f_rest_0..44 opacity scale_0..2
rot_0..3``. SH on disk is channel-planar; in memory it is interleaved RGB
per coefficient (``src/GSScene.cpp:47-55``). Parameters stay raw.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np

from tpusplat_torch.types import GaussianParams

_FLOATS_PER_VERTEX = 62
_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + [f"f_rest_{i}" for i in range(45)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def _parse_header(f) -> tuple[int, list[tuple[str, str]], str]:
    """Parse the text header; returns (num_vertices, [(type, name)], format)."""
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    num_vertices = 0
    fmt = ""
    props: list[tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                num_vertices = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            props.append((tokens[1], tokens[2]))
        elif tokens[0] == "end_header":
            break
    return num_vertices, props, fmt


def raw_arrays_from_records(rec: np.ndarray) -> dict[str, np.ndarray]:
    """Split [N, 62] float32 records into raw parameter arrays, interleaving
    SH as ``src/GSScene.cpp:47-55``."""
    n = rec.shape[0]
    sh_planar = rec[:, 6:54]  # [N, 48]: 3 DC + 15 per channel
    sh = np.empty((n, 16, 3), np.float32)
    sh[:, 0, :] = sh_planar[:, 0:3]
    sh[:, 1:, :] = np.moveaxis(sh_planar[:, 3:].reshape(n, 3, 15), 1, 2)
    return dict(
        means=rec[:, 0:3].copy(),
        sh=sh,
        opacities=rec[:, 54].copy(),
        log_scales=rec[:, 55:58].copy(),
        quats=rec[:, 58:62].copy(),  # (w, x, y, z) on disk; common.glsl:51-55
    )


def load_ply(path: str | os.PathLike, device="cuda", use_native: bool = True) -> GaussianParams:
    """Load a 3DGS .ply into raw GaussianParams on ``device``. The body is
    read by the native reader (built at first use; raises if it cannot be)
    unless ``use_native`` is False, then by numpy."""
    with open(path, "rb") as f:
        num_vertices, props, fmt = _parse_header(f)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt!r}")
        names = [p[1] for p in props]
        if names != _PROPS:
            # Any all-float layout holding our properties is reordered.
            missing = [p for p in _PROPS if p not in names]
            if missing or any(t != "float" for t, _ in props):
                raise ValueError(f"unsupported PLY vertex layout (missing {missing[:4]}...)")
        if use_native:
            from tpusplat_torch.io import native_loader

            rec = native_loader.read_records(path, f.tell(), num_vertices, len(props))
        else:
            rec = np.fromfile(f, dtype="<f4", count=num_vertices * len(props)).reshape(
                num_vertices, len(props))
    if names != _PROPS:
        rec = rec[:, [names.index(p) for p in _PROPS]]
    return GaussianParams.create(**raw_arrays_from_records(np.ascontiguousarray(rec)),
                                 device=device)


def save_ply(path: str | os.PathLike, params: GaussianParams, only_alive: bool = True) -> None:
    """Write raw GaussianParams in the standard 3DGS .ply layout (normals as
    zeros, ``src/GSScene.cpp:56-58``). A surfel scene (``SurfelParams``,
    two scales) is written in 2D Gaussian Splatting's layout, the same
    without ``scale_2``."""

    def arr(t, dtype=np.float32):
        return t.detach().cpu().numpy().astype(dtype)

    means, sh, opac = arr(params.means), arr(params.sh), arr(params.opacities)
    scales, quats = arr(params.log_scales), arr(params.quats)
    if only_alive:
        alive = arr(params.alive, bool)
        means, sh, opac, scales, quats = (a[alive] for a in (means, sh, opac, scales, quats))
    n = means.shape[0]

    rec = np.zeros((n, _FLOATS_PER_VERTEX), np.float32)
    rec[:, 0:3] = means
    rec[:, 6:9] = sh[:, 0, :]
    rec[:, 9:54] = np.moveaxis(sh[:, 1:, :], 2, 1).reshape(n, 45)
    rec[:, 54] = opac
    rec[:, 55:55 + scales.shape[1]] = scales
    rec[:, 58:62] = quats
    props = list(_PROPS)
    if scales.shape[1] == 2:
        del props[57]
        rec = np.delete(rec, 57, axis=1)

    header = _io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for name in props:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue())
        rec.astype("<f4").tofile(f)
