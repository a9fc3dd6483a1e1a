"""Loss oracles for the paper's PCA experiments: the 1-PCA loss (eq. 13) with
Krasulina's pseudo-gradient, and the alignment error against the true top
eigenvector. (The logistic-regression losses come with the convex track.)
"""
from __future__ import annotations

import torch


def pca_loss(w: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Population risk f(w) = -w^T Sigma w / ||w||^2."""
    return -(w @ cov @ w) / torch.clamp_min(w @ w, 1e-30)


def pca_excess_risk(w: torch.Tensor, cov: torch.Tensor,
                    lambda1: float) -> torch.Tensor:
    return pca_loss(w, cov) + lambda1


def krasulina_xi(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mini-batch Krasulina pseudo-gradient (Alg. 2, step 4, averaged over the
    local batch): xi = mean_b [ z_b (z_b.w) - ((w.z_b)^2/||w||^2) w ]."""
    zw = z @ w  # [n]
    nrm2 = torch.clamp_min(w @ w, 1e-30)
    return (z.T @ zw) / z.shape[0] - (torch.mean(zw**2) / nrm2) * w


def sin2_error(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sin^2 angle between w and the true eigenvector v (alignment error)."""
    c = (w @ v) ** 2 / (torch.clamp_min(w @ w, 1e-30) * (v @ v))
    return 1.0 - c
