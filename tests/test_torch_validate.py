"""The port's validation counters (tpusplat_torch/ops/validate.py) on the
CPU, the six cases of tests/test_validate.py: a clean scene passes with
every counter 0 and an image bit-equal to the one with the checks off;
poisoned means and SH trip the counters (the JAX package's counts, but
for how many pixels a NaN reaches) and raise; the plain path's counters;
no ``debug`` key with the checks off; and the ``TPUSPLAT_*`` environment
layer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.render import render_stages as jax_render_stages
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.validate import raise_on_violations
from tpusplat_torch.render import render, render_profiled, render_stages

torch.set_num_threads(2)


def _setup(n=200, w=64, h=48):
    """tests/test_validate.py's scene, on both sides."""
    jparams = jax_random_scene(n, seed=4, sh_degree=1, scale_range=(0.05, 0.3))
    jcam = jax_look_at([0.2, 0.1, 6.0], [0, 0, 0], w, h, fov_deg=60.0)
    jcfg = JaxConfig(sh_degree=1, capacity_mult=32, max_per_tile=1024, tile_chunk=4,
                     gauss_chunk=16, debug_checks=True)
    p, c = to_numpy(jparams), to_numpy(jcam)
    params = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                       p.alive, device="cpu")
    cam = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                    c.width, c.height, device="cpu")
    return (params, cam, convert.config_from_fields(dataclasses.asdict(jcfg))), \
        (jparams, jcam, jcfg)


def _counts(aux):
    return {k: int(v) for k, v in aux["debug"].items()}


def test_clean_scene_passes_and_image_unchanged():
    (params, cam, cfg), (jparams, jcam, jcfg) = _setup()
    img_dbg, aux = render_stages(params, cam, cfg)
    raise_on_violations(aux)  # must not raise
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in aux["debug"].values())
    assert _counts(aux) == _counts(jax_render_stages(jparams, jcam, jcfg)[1])
    assert not any(_counts(aux).values())
    img_ref, aux_ref = render_stages(params, cam, dataclasses.replace(cfg, debug_checks=False))
    assert torch.equal(img_dbg, img_ref)
    assert torch.equal(aux["transmittance"], aux_ref["transmittance"])


def test_nan_means_trip_validation():
    (params, cam, cfg), (jparams, jcam, jcfg) = _setup()
    means = params.means.clone()
    means[7] = float("nan")  # poisoned upstream data (e.g. a corrupt PLY record)
    _, aux = render_stages(dataclasses.replace(params, means=means), cam, cfg)
    jmeans = np.asarray(jparams.means).copy()
    jmeans[7] = np.nan
    _, jaux = jax_render_stages(dataclasses.replace(jparams, means=jnp.asarray(jmeans)), jcam,
                                jcfg)
    assert _counts(aux) == _counts(jaux)
    assert _counts(aux)["nonfinite_uv"] > 0
    with pytest.raises(RuntimeError, match="validation failed"):
        render(dataclasses.replace(params, means=means), cam, cfg)


def test_nan_sh_trips_validation():
    (params, cam, cfg), (jparams, jcam, jcfg) = _setup()
    sh = params.sh.clone()
    sh[3, 0, 1] = float("inf")
    _, aux = render_stages(dataclasses.replace(params, sh=sh), cam, cfg)
    jsh = np.asarray(jparams.sh).copy()
    jsh[3, 0, 1] = np.inf
    _, jaux = jax_render_stages(dataclasses.replace(jparams, sh=jnp.asarray(jsh)), jcam, jcfg)
    got, want = _counts(aux), _counts(jaux)
    # How far an Inf colour spreads as NaN through a tile's blend (Inf x 0)
    # is each blend's own; every other counter is the same.
    assert got.pop("nonfinite_pixels") > 0 and want.pop("nonfinite_pixels") > 0
    assert got == want and got["nonfinite_color"] > 0
    with pytest.raises(RuntimeError):
        raise_on_violations(aux)


def test_validation_counts_plain_path():
    """The JAX package's Pallas case: here the plain path, through
    render_profiled as well (which fills the counters too)."""
    (params, cam, cfg), (jparams, jcam, jcfg) = _setup()
    _, aux, _ = render_profiled(params, cam, cfg)
    raise_on_violations(aux)
    _, jaux = jax_render_stages(jparams, jcam, dataclasses.replace(jcfg, use_pallas=True))
    assert set(aux["debug"]) == set(jaux["debug"])
    assert not any(_counts(aux).values())


def test_no_debug_key_when_disabled():
    (params, cam, cfg), _ = _setup()
    _, aux = render_stages(params, cam, dataclasses.replace(cfg, debug_checks=False))
    assert "debug" not in aux
    raise_on_violations(aux)  # no-op without the key


def test_env_overrides(monkeypatch):
    """The TPUSPLAT_* layer; TPUSPLAT_USE_PALLAS has no field in the port."""
    base = RenderConfig()
    assert base.with_env_overrides() is base
    monkeypatch.setenv("TPUSPLAT_USE_PALLAS", "1")
    monkeypatch.setenv("TPUSPLAT_DEBUG_CHECKS", "true")
    monkeypatch.setenv("TPUSPLAT_CAPACITY_MULT", "6.5")
    monkeypatch.setenv("TPUSPLAT_MAX_PER_TILE", "512")
    cfg = base.with_env_overrides()
    assert cfg.debug_checks and not hasattr(cfg, "use_pallas")
    assert cfg.capacity_mult == 6.5 and cfg.max_per_tile == 512
    monkeypatch.setenv("TPUSPLAT_DEBUG_CHECKS", "off")
    assert not base.with_env_overrides().debug_checks
    monkeypatch.setenv("TPUSPLAT_GRAD_EXCHANGE", "compact")
    monkeypatch.setenv("TPUSPLAT_GRAD_A2A_MULT", "1.7")
    monkeypatch.setenv("TPUSPLAT_STRIP_GAUSS_MULT", "2.5")
    cfg2 = base.with_env_overrides()
    assert cfg2.grad_exchange == "compact"
    assert cfg2.grad_a2a_mult == 1.7 and cfg2.strip_gauss_mult == 2.5
    monkeypatch.setenv("TPUSPLAT_GRAD_EXCHANGE", "Compact")  # a typo fails loudly
    with pytest.raises(ValueError):
        base.with_env_overrides()
