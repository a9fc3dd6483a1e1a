"""The paper's synthetic data generators.

* Logistic-link labels with standard-normal features (Fig. 6): w* ~ N(0, I),
  x ~ N(0, I_d), Pr(y=1|x) = sigmoid(w*.x + b*).
* Conditional Gaussians (Fig. 9): mu_{+-1} ~ N(0, I), x | y ~ N(mu_y,
  sigma_x^2 I).
* Spiked / power-law covariance streams for the PCA experiments (Figs.
  7-8): lambda_1 = 1 and a prescribed eigengap.

Every `draw(generator, n)` draws on the stream's device from an explicit
`torch.Generator` (the port's stand-in for a threefry key): the same
distributions as the reference, never the same numbers. The problem itself
(w*, the class means, the covariance) comes from a `torch.Generator` too;
`repro_torch.convert` carries the reference's numbers across when both
packages must learn the same problem.

Two sources of the same PCA stream:

* `PCAStream.draw(generator, n)` draws on the stream's device from an
  explicit `torch.Generator` (the port's stand-in for a threefry key). The
  covariance itself comes from a `torch.Generator` too, so it is NOT the JAX
  package's covariance for the same seed; `convert.pca_stream` carries the
  reference's numbers across when a test needs the same stream.
* `make_pca_host_sampler` is numpy: for the same `sqrt_cov` and seed it gives
  exactly the draws of the JAX package's host sampler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.paper_logreg import LogRegConfig
from repro_torch.configs.paper_pca import PCAConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LogRegStream:
    """A logistic-regression stream: `draw(generator, n)` -> (x [n, d],
    y [n] in {-1, +1}) on the stream's device."""

    cfg: LogRegConfig
    w_star: torch.Tensor  # [d+1] (weights, bias) ground truth
    mus: Optional[torch.Tensor] = None  # [2, d] class means (cond_gauss)

    def draw(self, generator: torch.Generator, n: int):
        dev = self.w_star.device
        d = self.cfg.dim
        if self.cfg.generator == "logistic_link":
            x = torch.randn((n, d), generator=generator, device=dev)
            logits = x @ self.w_star[:-1] + self.w_star[-1]
            y = 2.0 * torch.bernoulli(torch.sigmoid(logits),
                                      generator=generator) - 1.0
            return x, y
        y = 2.0 * torch.bernoulli(torch.full((n,), 0.5, device=dev),
                                  generator=generator) - 1.0
        mu = torch.where(y[:, None] > 0, self.mus[1], self.mus[0])
        noise = torch.randn((n, d), generator=generator, device=dev)
        return mu + self.cfg.noise_var ** 0.5 * noise, y


def logreg_w_star(cfg: LogRegConfig, mus: torch.Tensor) -> torch.Tensor:
    """Bayes-optimal linear separator of the Fig. 9 conditional Gaussians
    (equal covariances): w* = (mu_1 - mu_0)/sigma^2,
    b* = -(|mu_1|^2 - |mu_0|^2)/(2 sigma^2)."""
    w = (mus[1] - mus[0]) / cfg.noise_var
    b = -((mus[1] ** 2).sum() - (mus[0] ** 2).sum()) / (2 * cfg.noise_var)
    return torch.cat([w, b.reshape(1)])


def make_logreg_stream(cfg: LogRegConfig, *,
                       device: DeviceLike = None) -> LogRegStream:
    """The stream of `cfg`, its ground truth drawn from a `torch.Generator`
    seeded with `cfg.seed` on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    if cfg.generator == "logistic_link":
        return LogRegStream(cfg, torch.randn((cfg.dim + 1,), generator=gen,
                                             device=dev))
    if cfg.generator != "cond_gauss":
        raise ValueError(f"unknown generator {cfg.generator!r}")
    mus = torch.randn((2, cfg.dim), generator=gen, device=dev)  # class -1, +1
    return LogRegStream(cfg, logreg_w_star(cfg, mus), mus)


@dataclasses.dataclass(frozen=True)
class PCAStream:
    cov: torch.Tensor  # [d, d]
    top_eigvec: torch.Tensor  # [d]
    lambda1: float
    eigengap: float
    sqrt_cov: torch.Tensor  # [d, d] symmetric square root of cov

    def draw(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n samples z ~ N(0, cov), [n, d], on the stream's device."""
        d = self.sqrt_cov.shape[0]
        g = torch.randn((n, d), generator=generator,
                        device=self.sqrt_cov.device)
        return g @ self.sqrt_cov


def make_pca_stream(cfg: PCAConfig, *, device: DeviceLike = None) -> PCAStream:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    d = cfg.dim
    lam2 = cfg.lambda1 - cfg.eigengap
    if cfg.spectrum == "power":
        rest = lam2 * torch.arange(1, d, dtype=torch.float32,
                                   device=dev) ** -0.7
    else:
        rest = torch.linspace(lam2, 0.01 * cfg.lambda1, d - 1, device=dev)
    evals = torch.cat([torch.tensor([cfg.lambda1], device=dev), rest])
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=dev))
    cov = (q * evals) @ q.T
    sqrt_cov = (q * torch.sqrt(evals)) @ q.T
    return PCAStream(cov, q[:, 0].contiguous(), float(cfg.lambda1),
                     float(cfg.eigengap), sqrt_cov)


def make_pca_host_sampler(stream: PCAStream) -> Callable:
    """Host-side splitter source for the streaming engine: the same covariance
    stream as `PCAStream.draw`, but numpy-generated (np.random.Generator in,
    {"z": [n, d]} dict out) so `data.pipeline.StreamingPipeline` and the
    `DevicePrefetcher` thread can synthesize samples off the device's critical
    path. Identical draws to the JAX package's sampler for the same
    `sqrt_cov` and seed."""
    sqrt_cov = stream.sqrt_cov.detach().cpu().numpy().astype(np.float32)
    d = sqrt_cov.shape[0]

    def sample(rng: "np.random.Generator", n: int):
        z = rng.standard_normal((n, d), dtype=np.float32) @ sqrt_cov
        return {"z": z}

    return sample
