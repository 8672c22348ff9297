"""The port's losses (tpusplat_torch/train/losses.py) on the CPU against the
JAX package's (tpusplat/train/losses.py), on the same seeded images: values
and the gradient of gs_loss at atol 1e-5 (float32 sums of a few thousand
terms in another order), plus the behavioural tests of tests/test_losses.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.train import losses as jl
from tpusplat_torch.train import losses as tl

torch.set_num_threads(2)


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


SHAPES = [(24, 32, 3), (2, 20, 18, 3)]


def test_gaussian_window_matches_jax():
    np.testing.assert_allclose(tl._gaussian_window().numpy(),
                               np.asarray(jl._gaussian_window()), atol=1e-8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["l1_loss", "psnr", "gs_loss"])
def test_scalar_losses_match_jax(name, shape):
    a, b = _pair(shape)
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("crop_border", [False, True])
def test_ssim_matches_jax(shape, crop_border):
    a, b = _pair(shape, seed=1)
    want = float(jl.ssim(jnp.asarray(a), jnp.asarray(b), crop_border=crop_border))
    got = float(tl.ssim(torch.from_numpy(a), torch.from_numpy(b), crop_border=crop_border))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ssim_map_matches_jax():
    a, b = _pair((2, 20, 18, 3), seed=2)
    want = np.asarray(jl.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    got = tl.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ssim_weight", [0.2, 1.0])
def test_gs_loss_grad_matches_jax(ssim_weight):
    a, b = _pair((24, 32, 3), seed=3)
    want = np.asarray(jax.grad(lambda x: jl.gs_loss(x, jnp.asarray(b), ssim_weight))(
        jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    tl.gs_loss(x, torch.from_numpy(b), ssim_weight).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5)


def test_psnr_identity_and_ordering():
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(
        np.float32))
    assert float(tl.psnr(img, img)) >= 99.0  # clamped mse floor -> 100 dB
    near = torch.clamp(img + 0.01, 0, 1)
    far = torch.clamp(img + 0.2, 0, 1)
    assert float(tl.psnr(img, near)) > float(tl.psnr(img, far)) > 0.0


def test_ssim_crop_border_is_proper_score():
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 1, (48, 48, 3)).astype(np.float32))
    s_id = float(tl.ssim(img, img, crop_border=True))
    np.testing.assert_allclose(s_id, 1.0, atol=1e-5)
    noisy = torch.clamp(img + torch.from_numpy(
        rng.normal(0, 0.05, img.shape).astype(np.float32)), 0, 1)
    assert float(tl.ssim(img, noisy, crop_border=True)) < s_id


def test_gs_loss_zero_at_identity_up_to_padding_bias():
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (32, 32, 3)).astype(
        np.float32))
    assert abs(float(tl.gs_loss(img, img))) < 0.05
