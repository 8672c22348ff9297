"""Training step: Adam on raw Gaussian parameters (counterpart of
``tpusplat/train/step.py``).

Per-parameter learning rates follow the original 3DGS recipe (means get an
exponentially decaying lr scaled by the scene extent; opacity, scales,
rotation and SH fixed lrs), as ``optax.multi_transform`` of
``optax.adam(eps=1e-15)`` per group in the JAX package. The Adam here is
written out, because ``torch.optim.Adam`` cannot skip an update without
reading the overflow counters on the host: an overflowed step is gated on
the device with ``torch.where``, and the caller polls the counters one step
late (``tpusplat_torch/trainer.py``).

PyTorch runs eagerly, so there is no jit; :func:`train_step` is functional
(it returns a new state and leaves the old one intact, as in JAX).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.render import render_stages
from tpusplat_torch.train.losses import gs_loss
from tpusplat_torch.types import Camera, GaussianParams

TRAINABLE = ("means", "log_scales", "quats", "opacities", "sh")


def split_trainable(params: GaussianParams):
    """(dict of trainable tensors, alive mask)."""
    return {f: getattr(params, f) for f in TRAINABLE}, params.alive


def merge_trainable(trainable: dict, alive: torch.Tensor) -> GaussianParams:
    return GaussianParams(alive=alive, **trainable)


# optax.adam's decay rates, and the eps of the JAX package's make_optimizer.
B1, B2, EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam per parameter group with the 3DGS learning rates; the fields
    are the arguments of the JAX ``make_optimizer``."""

    means_lr: float = 1.6e-4
    means_lr_final: float = 1.6e-6
    means_lr_max_steps: int = 30_000
    scales_lr: float = 5e-3
    quats_lr: float = 1e-3
    opacities_lr: float = 5e-2
    sh_lr: float = 2.5e-3
    scene_extent: float = 1.0

    def learning_rate(self, name: str, count: torch.Tensor):
        """The group's learning rate at its update count (read before the
        count is incremented). The means follow ``optax.exponential_decay(
        init * extent, transition_steps=max_steps, decay_rate=final/init,
        end_value=final * extent)``; the other groups are constant."""
        if name != "means":
            return dict(log_scales=self.scales_lr, quats=self.quats_lr,
                        opacities=self.opacities_lr, sh=self.sh_lr)[name]
        init = self.means_lr * self.scene_extent
        rate = self.means_lr_final / self.means_lr
        if self.means_lr_max_steps <= 0 or rate == 0:
            return init
        end = self.means_lr_final * self.scene_extent
        p = count.to(torch.float32) / self.means_lr_max_steps
        value = torch.where(count <= 0, init, init * torch.pow(rate, p))
        return torch.clamp_min(value, end) if rate < 1.0 else torch.clamp_max(value, end)


make_optimizer = Optimizer  # the JAX package's name


@dataclasses.dataclass
class TrainState:
    """Parameters, Adam state (per group: first and second moments and an
    int32 update count) and the densification statistics, all tensors on
    the parameters' device."""

    params: GaussianParams
    mu: dict
    nu: dict
    count: dict
    step: torch.Tensor  # 0-d int32: applied (not gated) steps
    grad_accum: torch.Tensor  # [N] sum of ||d loss / d means|| over visible steps
    grad_count: torch.Tensor  # [N] number of steps each Gaussian was visible
    max_radii: torch.Tensor  # [N] largest screen radius seen


def create_train_state(params: GaussianParams) -> TrainState:
    """Zero moments, counts and statistics (the Adam state does not depend
    on the learning rates)."""
    trainable, _ = split_trainable(params)
    dev = params.device
    n = params.num_gaussians

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return TrainState(
        params=params,
        mu={k: torch.zeros_like(v) for k, v in trainable.items()},
        nu={k: torch.zeros_like(v) for k, v in trainable.items()},
        count={k: torch.zeros((), dtype=torch.int32, device=dev) for k in TRAINABLE},
        step=torch.zeros((), dtype=torch.int32, device=dev),
        grad_accum=zeros((n,)),
        grad_count=zeros((n,)),
        max_radii=zeros((n,)),
    )


def adam_update(optimizer: Optimizer, trainable: dict, grads: dict, mu: dict, nu: dict,
                count: dict):
    """One Adam step per group, in optax's order of operations: moments,
    count + 1, bias correction, ``m / (sqrt(v) + eps)``, times ``-lr`` read
    at the count before the increment. Returns new (trainable, mu, nu,
    count) dicts."""
    new_p, new_mu, new_nu, new_count = {}, {}, {}, {}
    for k in TRAINABLE:
        g = grads[k]
        m = (1 - B1) * g + B1 * mu[k]
        v = (1 - B2) * (g * g) + B2 * nu[k]
        c = count[k] + 1
        cf = c.to(torch.float32)
        m_hat = m / (1 - torch.pow(B1, cf))
        v_hat = v / (1 - torch.pow(B2, cf))
        u = m_hat / (torch.sqrt(v_hat) + EPS)
        new_p[k] = trainable[k] + (-optimizer.learning_rate(k, count[k])) * u
        new_mu[k], new_nu[k], new_count[k] = m, v, c
    return new_p, new_mu, new_nu, new_count


def step_forward(state: TrainState, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
                 ssim_weight: float = 0.2):
    """Render the state's parameters with gradients on and take the loss.
    Returns (loss, aux, leaves): ``leaves`` are the trainable tensors the
    gradients are taken against."""
    trainable, alive = split_trainable(state.params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
    img, aux = render_stages(merge_trainable(leaves, alive), camera, cfg)
    return gs_loss(img, target, ssim_weight), aux, leaves


def step_backward(loss: torch.Tensor, leaves: dict) -> dict:
    """d loss / d leaves, as a dict."""
    grads = torch.autograd.grad(loss, [leaves[k] for k in TRAINABLE])
    return dict(zip(TRAINABLE, grads))


@torch.no_grad()
def apply_gradients(state: TrainState, loss, aux: dict, grads: dict, optimizer: Optimizer):
    """The Adam update and the densification statistics, gated on the
    device: a step whose render overflowed any capacity leaves every tensor
    of the state bit-identical (``step.py:114-126`` of the JAX package).
    Returns (state, metrics); no value is read on the host."""
    trainable, alive = split_trainable(state.params)
    params, mu, nu, count = adam_update(optimizer, trainable, grads, state.mu, state.nu,
                                        state.count)
    ok = (aux["capacity_overflow"] + aux["gauss_overflow"] + aux["tile_overflow"]) == 0

    def keep(new: dict, old: dict) -> dict:
        return {k: torch.where(ok, new[k], old[k]) for k in new}

    gnorm = torch.linalg.vector_norm(grads["means"], dim=-1)
    visible = aux["visible"].to(torch.float32)
    radius = aux["radius"].detach()
    new_state = TrainState(
        params=merge_trainable(keep(params, trainable), alive),
        mu=keep(mu, state.mu),
        nu=keep(nu, state.nu),
        count=keep(count, state.count),
        step=state.step + ok.to(torch.int32),
        grad_accum=state.grad_accum + torch.where(ok, gnorm, 0.0),
        grad_count=state.grad_count + torch.where(ok, visible, 0.0),
        max_radii=torch.where(ok, torch.maximum(state.max_radii, radius), state.max_radii),
    )
    metrics = dict(
        loss=loss.detach(),
        num_instances=aux["num_instances"],
        capacity_overflow=aux["capacity_overflow"],
        gauss_overflow=aux["gauss_overflow"],
        tile_overflow=aux["tile_overflow"],
    )
    return new_state, metrics


def train_step(state: TrainState, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
               optimizer: Optimizer, ssim_weight: float = 0.2):
    """One optimization step on a single camera. Returns (state, metrics).

    Forward and backward run on the parameters' device: on the card through
    the emission, forward-blend, backward-blend and segment-reduce kernels.
    The update is a no-op while any overflow counter of the render is
    nonzero; the counters come back in ``metrics`` as device tensors."""
    loss, aux, leaves = step_forward(state, camera, target, cfg, ssim_weight)
    grads = step_backward(loss, leaves)
    return apply_gradients(state, loss, aux, grads, optimizer)
