"""Robust statistics for the GN solver (port of ``plslam_tpu/core/robust.py``).

All masked and batched over leading dimensions: invalid entries never
influence the statistics.
"""

from __future__ import annotations

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


def mad_scale_zero_centered(r_abs: torch.Tensor, mask: torch.Tensor,
                            min_scale: float = 1e-4) -> torch.Tensor:
    """MAD scale assuming a zero-centred residual (|r| given)."""
    return torch.clamp(_MAD_SIGMA * masked_median(r_abs, mask), min=min_scale)


def tstudent_weight(r: torch.Tensor, sigma: torch.Tensor,
                    dof: float = 5.0) -> torch.Tensor:
    """t-distribution robust weight w = (dof + 1) / (dof + (r/sigma)^2)."""
    den = dof + (r / sigma) ** 2
    return torch.full_like(den, dof + 1.0) / den
