"""Parameter activations (counterpart of ``tpusplat/ops/activations.py``):
``scale = exp(raw)``, ``opacity = sigmoid(raw)``, ``rotation = normalize(q)``,
applied in the autograd graph so gradients reach the raw parameters."""

from __future__ import annotations

import torch


def activate_scales(log_scales: torch.Tensor, modifier: float = 1.0) -> torch.Tensor:
    s = torch.exp(log_scales)
    return s * modifier if modifier != 1.0 else s


def activate_opacity(raw: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw)


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
