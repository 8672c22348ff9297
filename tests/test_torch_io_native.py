"""The port's native PLY reader (tpusplat_torch/io/native_loader.py), built
here with the C++ compiler from native/ply_loader.cpp: field by field equal
to the numpy read and to the JAX package's reader; a reordered layout; and
a build that cannot happen raises instead of reading with numpy."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat.io.ply import load_ply as jax_load_ply
from tpusplat.types import to_numpy
from tpusplat_torch.io import native_loader
from tpusplat_torch.io.ply import _PROPS, load_ply, save_ply
from tpusplat_torch.io.synthetic import random_scene

torch.set_num_threads(2)

FIELDS = ("means", "log_scales", "quats", "opacities", "sh", "alive")


def test_native_loader_matches_numpy_and_jax(tmp_path):
    params = random_scene(123, seed=3, device="cpu")
    path = tmp_path / "scene.ply"
    save_ply(path, params)
    a = load_ply(path, device="cpu", use_native=False)
    b = load_ply(path, device="cpu", use_native=True)
    ref = dataclasses.asdict(to_numpy(jax_load_ply(path, use_native=False)))
    assert native_loader.library_path().exists()
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        np.testing.assert_array_equal(getattr(b, f).numpy(), ref[f], err_msg=f)
        np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(params, f).numpy(),
                                      err_msg=f)


def test_native_loader_reorders_a_permuted_layout(tmp_path):
    """An all-float layout in another property order reads the same."""
    params = random_scene(40, seed=5, device="cpu")
    path = tmp_path / "scene.ply"
    save_ply(path, params)
    raw = path.read_bytes()
    head, body = raw.split(b"end_header\n", 1)
    rec = np.frombuffer(body, "<f4").reshape(40, 62)
    order = np.random.default_rng(0).permutation(62)
    lines = [ln for ln in head.split(b"\n") if not ln.startswith(b"property")]
    props = [f"property float {_PROPS[i]}".encode() for i in order]
    perm = tmp_path / "perm.ply"
    perm.write_bytes(b"\n".join(lines[:-1] + props + [b"end_header\n"])
                     + rec[:, order].astype("<f4").tobytes())
    a = load_ply(perm, device="cpu", use_native=True)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(params, f)), f


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_native_loader_raises_when_it_cannot_build(tmp_path, monkeypatch, cxx):
    """A missing compiler, or one that fails: the read raises; it never
    falls back to numpy."""
    path = tmp_path / "scene.ply"
    save_ply(path, random_scene(8, seed=1, device="cpu"))
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native PLY reader"):
        load_ply(path, device="cpu", use_native=True)
    assert not list((tmp_path / "build").glob("*.so"))
    assert load_ply(path, device="cpu", use_native=False).num_gaussians == 8
