"""Loss oracles for the paper's experiments: the smooth convex logistic loss
(with its gradient in closed form) and the 1-PCA loss (eq. 13) with
Krasulina's pseudo-gradient and the alignment error against the true top
eigenvector.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Logistic regression (convex, smooth)
# ---------------------------------------------------------------------------


def logistic_loss(w: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """w: [d+1] (weights, bias); x: [n, d]; y: [n] in {-1, +1}."""
    z = x @ w[:-1] + w[-1]
    return torch.logaddexp(torch.zeros_like(z), -y * z).mean()


def logistic_grad(w: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Gradient of `logistic_loss` in w, in closed form (the reference takes
    `jax.grad`): mean_i -y_i sigmoid(-y_i z_i) [x_i, 1]. Pure tensor code, so
    `torch.func.vmap` maps it over nodes."""
    z = x @ w[:-1] + w[-1]
    coef = -y * torch.sigmoid(-y * z) / x.shape[0]  # [n]
    return torch.cat([coef @ x, coef.sum().reshape(1)])


def logistic_risk(w: torch.Tensor, draw, generator: torch.Generator,
                  n: int = 20_000) -> torch.Tensor:
    x, y = draw(generator, n)
    return logistic_loss(w, x, y)


def project_ball(w: torch.Tensor, radius: float) -> torch.Tensor:
    """Projection onto the l2 ball of given radius (bounded model space W)."""
    nrm = torch.linalg.vector_norm(w)
    return torch.where(nrm > radius, w * (radius / nrm), w)


# ---------------------------------------------------------------------------
# 1-PCA (structured nonconvex, eq. 13)
# ---------------------------------------------------------------------------


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
