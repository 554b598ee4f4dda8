"""Robust statistics for the GN/LM solvers (port of ``plslam_tpu/core/robust.py``).

All masked and batched over leading dimensions: invalid entries never
influence the statistics.
"""

from __future__ import annotations

import math

import torch

# 1 / Phi^-1(3/4): consistency constant making MAD estimate sigma for gaussians
_MAD_SIGMA = 1.4826


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x[mask] along the last axis, fixed-shape.

    Invalid entries sort to the largest finite float and the index comes
    from the true count, so an even count gives the LOWER middle element
    (the reference's behaviour, not numpy's mean of the two middles).
    """
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big), dim=-1).values
    n = torch.sum(mask, dim=-1)
    idx = torch.clamp((n - 1) // 2, min=0)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def mad_scale(r: torch.Tensor, mask: torch.Tensor,
              min_scale: float = 1e-4) -> torch.Tensor:
    """Robust sigma via MAD (auxiliar.cpp::vector_stdv_mad):
    1.4826 median(|r - median(r)|), floored to keep weights finite."""
    med = masked_median(r, mask)
    sigma = _MAD_SIGMA * masked_median(torch.abs(r - med[..., None]), mask)
    return torch.clamp(sigma, min=min_scale)


def mad_scale_zero_centered(r_abs: torch.Tensor, mask: torch.Tensor,
                            min_scale: float = 1e-4) -> torch.Tensor:
    """MAD scale assuming a zero-centred residual (|r| given)."""
    return torch.clamp(_MAD_SIGMA * masked_median(r_abs, mask), min=min_scale)


def tstudent_weight(r: torch.Tensor, sigma: torch.Tensor,
                    dof: float = 5.0) -> torch.Tensor:
    """t-distribution robust weight w = (dof + 1) / (dof + (r/sigma)^2)."""
    den = dof + (r / sigma) ** 2
    return torch.full_like(den, dof + 1.0) / den


def cauchy_weight(r: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Cauchy robust weight w = 1 / (1 + (r/sigma)^2)."""
    den = 1.0 + (r / sigma) ** 2
    return torch.ones_like(den) / den


def huber_weight(r: torch.Tensor, k) -> torch.Tensor:
    """Huber weight: 1 inside |r| <= k, k/|r| outside."""
    a = torch.abs(r)
    k = torch.as_tensor(k, dtype=a.dtype, device=a.device)
    return torch.where(a <= k, torch.ones_like(a),
                       k / torch.clamp(a, min=1e-12))


def pose_cov_entropy(cov: torch.Tensor) -> torch.Tensor:
    """Differential entropy (up to a constant) of a 6x6 pose covariance,
    0.5 log det(cov), -inf where the determinant is not positive (the
    reference's keyframe criterion, currFrameIsKF's entropy ratio)."""
    sign, logdet = torch.linalg.slogdet(cov)
    return 0.5 * torch.where(sign > 0, logdet,
                             torch.full_like(logdet, -math.inf))
