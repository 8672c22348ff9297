"""The work model and the trace's arithmetic against hand counts."""

import importlib.util
import math
import os
import types

import pytest
import torch

from conftest import ROOT
from splatbench import reference, workmodel as wm
from splatbench.trace import Trace, merged

HERE = os.path.join(ROOT, "splatbench")


def one_tile(attrs):
    """_blend over one 16x16 tile at the origin for Gaussians ``attrs``
    ([K, 9] rows: u, v, a, b, c, opacity, r, g, b) in depth order."""
    a = torch.tensor(attrs, dtype=torch.float32)[None]
    lin = torch.arange(256)
    px, py = (lin % 16).float()[None], (lin // 16).float()[None]
    return reference._blend(a, torch.ones(a.shape[:2], dtype=torch.bool), px, py)


def test_footprint_pairs_by_hand():
    """One Gaussian: the pixels where op exp(-r^2 / (2 s^2)) >= 1/255, all
    unsaturated, so every evaluated pair contributes."""
    s2, op = 4.0, 0.5
    rgb, ev, co = one_tile([[7.0, 6.0, 1 / s2, 0.0, 1 / s2, op, 1, 1, 1]])
    want = sum(op * math.exp(-((x - 7) ** 2 + (y - 6) ** 2) / (2 * s2)) >= 1 / 255
               for x in range(16) for y in range(16))
    assert ev == co == want > 0


def test_saturation_by_hand():
    """Twenty Gaussians of opacity 1/2 stacked on pixel (3, 5), so narrow
    that no other pixel passes: the transmittance after the j-th is 2^-j,
    so 13 contribute (2^-13 >= 1e-4 > 2^-14), the 14th is evaluated and
    stops the pixel, and the rest are not evaluated."""
    rgb, ev, co = one_tile([[3.0, 5.0, 1e4, 0.0, 1e4, 0.5, 1, 0, 0]] * 20)
    assert (ev, co) == (14, 13)
    assert float(rgb[0, 5 * 16 + 3, 0]) == pytest.approx(1 - 2 ** -13)


def test_operation_counts_by_hand():
    pairs = dict(evaluated=14, contributing=13)
    assert wm.frame_ops(10, pairs, 256) == 10 * 389 + 14 * 14 + 13 * 9
    assert wm.blend_bwd(pairs, 2, 256) == (13 * 47, 2 * 2 * 36 + 16 * 256)
    step = wm.train_step_ops(10, 12, pairs, 256)
    assert step == (10 * (389 + 778) + 14 * 14 + 13 * 9 + 13 * 47 + 3 * 256 * (243 + 486)
                    + 12 * (59 * 14 + 9))
    assert wm.bound_s(67e12, 0) == pytest.approx(1.0)
    assert wm.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_merged_intervals():
    assert merged([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 0, 10) == pytest.approx(4.0)
    assert merged([(0, 2), (8, 12)], 1, 10) == pytest.approx(3.0)


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_roofline_reads_100_at_the_bound():
    """A forward kernel that takes exactly the least time its inputs need
    reads 100%; a library kernel with a like name is not counted."""
    work = dict(evaluated=1e8, contributing=5e7, visible=1e6, alive=1e6)
    pixels = 1920 * 1080
    t = wm.bound_s(*wm.blend_fwd(work, work["visible"], pixels))
    trace = Trace(window_s=1.0, spans=[], device=[
        ("void (anonymous namespace)::forward_kernel(float const*)", 0.1, 0.1 + t),
        ("void (anonymous namespace)::forward_kernel(float const*)", 0.5, 0.5 + t),
        ("void at::native::cumprod_forward_kernel(float)", 0.2, 0.4)],
        units=2, unit_s_untraced=0.25)
    run = types.SimpleNamespace(trace=trace, work=work, pixels=pixels)
    assert _reader("blend_fwd_roofline.view")(run) == pytest.approx(100.0)
    # The idle share and mfu take the untraced loop's time, 2 x 0.25 s, as
    # their window, not the traced 1 s.
    assert _reader("idle_share.view")(run) == pytest.approx(100 * (1 - (0.2 + 2 * t) / 0.5))
    assert _reader("mfu.view")(run) == pytest.approx(
        100 * wm.frame_ops(work["alive"], work, pixels) / 0.25 / wm.PEAK_FP32_FLOPS)


def test_readers_are_silent_without_their_source():
    run = types.SimpleNamespace(trace=None, work={}, pixels=1, spans={}, ranks=[], chips=1)
    for name in os.listdir(os.path.join(HERE, "metrics")):
        assert _reader(name[:-3])(run) is None, name
