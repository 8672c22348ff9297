"""The port's differentiable golden oracle (``tpusplat_torch.ops.golden``)
against the JAX package's ``golden_render_jnp`` on the same scene: the image
within atol 1e-5, and the gradients of a mean squared error to a seeded
target with respect to the five trainable tensors within 1e-4 of each
tensor's largest magnitude (the normalisation of ``tpu_gate._grad_diffs``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.ops.golden import golden_render_jnp
from tpusplat.train.step import merge_trainable as jax_merge, split_trainable as jax_split
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.ops.golden import golden_render
from tpusplat_torch.train.step import TRAINABLE, merge_trainable, split_trainable

torch.set_num_threads(2)


def _grad_diffs(g_ref, g_test):
    return {f: float(np.abs(np.asarray(g_test[f], np.float64) - np.asarray(g_ref[f], np.float64)
                            ).max() / (np.abs(np.asarray(g_ref[f], np.float64)).max() + 1e-12))
            for f in TRAINABLE}


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_golden_render_matches_jax(sh_degree):
    w, h = 64, 48
    params = jax_random_scene(300, seed=4, sh_degree=sh_degree, scale_range=(0.05, 0.3))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], w, h, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=sh_degree)
    target = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)

    trainable, alive = jax_split(params)

    def loss_j(tr):
        img = golden_render_jnp(jax_merge(tr, alive), cam, cfg)
        return jnp.mean((img - target) ** 2), img

    (_, img_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(trainable)

    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh, p.alive,
                                   device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    tr, alive_t = split_trainable(tp)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tr.items()}
    img = golden_render(merge_trainable(leaves, alive_t), tc,
                        convert.config_from_fields(dataclasses.asdict(cfg)))
    loss = torch.mean((img - torch.from_numpy(target)) ** 2)
    g_t = dict(zip(TRAINABLE, torch.autograd.grad(loss, [leaves[k] for k in TRAINABLE])))

    assert float(img.detach().max()) > 0.05  # the scene is in view
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), atol=1e-5)
    diffs = _grad_diffs({k: np.asarray(v) for k, v in g_j.items()},
                        {k: v.numpy() for k, v in g_t.items()})
    assert all(v <= 1e-4 for v in diffs.values()), diffs
