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

The scenario harness's non-IID host samplers are numpy too, copied from the
reference: `make_drifting_pca_sampler` (a rotating top eigenvector) gives
the reference's draws over the same base covariance, and
`make_skewed_logreg_sampler` (Beta-distributed per-node label skew) gives
them for the same config and seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# Non-IID streams (scenario harness — docs/DESIGN.md §Scenario harness)
# ---------------------------------------------------------------------------


class DriftingPCAStream(NamedTuple):
    """Host-side PCA stream whose top eigenvector rotates over time."""

    sample: Callable  # (np rng, n) -> {"z": [n, d]}
    top_eigvec_at: Callable  # t_samples -> [d] unit vector (ground truth)
    cov_at: Callable  # t_samples -> [d, d]
    rate: float  # radians of rotation per sample drawn
    lambda1: float
    eigengap: float


def make_drifting_pca_sampler(cfg: PCAConfig, *, rate: float,
                              stream: Optional[PCAStream] = None,
                              device: DeviceLike = None
                              ) -> DriftingPCAStream:
    """Drifting-covariance PCA stream for `data.pipeline.StreamingPipeline`:
    the spectrum (lambda_1, eigengap, tail) is that of `stream` (default
    `make_pca_stream(cfg, device=device)`), but the top eigenvector rotates
    in the fixed plane spanned by the first two eigenvectors at `rate`
    radians per sample drawn — a stateful host sampler (the splitter
    produces sequentially, so the drift clock is deterministic for a fixed
    seed regardless of prefetch depth; discarded mu samples advance it too).
    The covariance is held constant within each drawn batch;
    `top_eigvec_at(t)` / `cov_at(t)` give the ground truth at sample count
    t. Over `convert.pca_stream` of the reference's stream its draws are the
    reference's."""
    base = stream if stream is not None else make_pca_stream(cfg,
                                                            device=device)
    cov0 = base.cov.detach().cpu().numpy().astype(np.float64)
    evals, q = np.linalg.eigh(cov0)
    order = np.argsort(evals)[::-1]
    evals, q = np.maximum(evals[order], 0.0), q[:, order]
    d = q.shape[0]

    def _basis_at(t: float):
        theta = rate * float(t)
        c, s = np.cos(theta), np.sin(theta)
        qt = q.copy()
        qt[:, 0] = c * q[:, 0] + s * q[:, 1]
        qt[:, 1] = -s * q[:, 0] + c * q[:, 1]
        return qt

    def top_eigvec_at(t: float):
        return _basis_at(t)[:, 0]

    def cov_at(t: float):
        qt = _basis_at(t)
        return (qt * evals) @ qt.T

    state = {"t": 0}

    def sample(rng: "np.random.Generator", n: int):
        qt = _basis_at(state["t"])
        state["t"] += n
        sqrt_cov = ((qt * np.sqrt(evals)) @ qt.T).astype(np.float32)
        z = rng.standard_normal((n, d), dtype=np.float32) @ sqrt_cov
        return {"z": z}

    return DriftingPCAStream(sample, top_eigvec_at, cov_at, float(rate),
                             float(cfg.lambda1), float(cfg.eigengap))


class SkewedLogRegStream(NamedTuple):
    """Label-skewed per-node logreg stream (host-side, conditional Gaussians)."""

    sample: Callable  # (np rng, n) -> {"x": [n, d], "y": [n] in {-1, +1}}
    w_star: Any  # [d+1] Bayes-optimal (weights, bias) under the POOLED mixture
    node_pos_prob: Any  # [n_nodes] per-node P(y = +1)
    alpha: float
    n_nodes: int


def make_skewed_logreg_sampler(cfg: LogRegConfig, n_nodes: int, *,
                               alpha: float, seed: Optional[int] = None,
                               ) -> SkewedLogRegStream:
    """Label-skewed logreg partitions: each node's class-(+1) proportion is an
    independent draw p_i ~ Beta(alpha, alpha) — the 2-class Dirichlet(alpha)
    partition of the federated non-IID literature (small alpha = severe
    skew, alpha = inf is IID). Features are the paper's Fig. 9 conditional
    Gaussians around fixed class means. numpy throughout, so the same
    config and seed give the reference's draws.

    Every draw of n samples lays the nodes out as *contiguous blocks* (node i
    owns samples [i*n/N, (i+1)*n/N)), the split `train.trainer.
    make_node_batch` applies — so with mu = 0 and B a multiple of n_nodes,
    node i's device batch is node i's skewed partition."""
    if n_nodes < 1:
        raise ValueError(f"need at least one node: {n_nodes}")
    if alpha <= 0:
        raise ValueError(f"Dirichlet concentration must be > 0: {alpha}")
    rng0 = np.random.default_rng(cfg.seed if seed is None else seed)
    mus = rng0.standard_normal((2, cfg.dim))  # rows: class -1, +1
    # alpha = inf is the exact IID limit (Beta(inf, inf) -> point mass at 1/2)
    p = (np.full(n_nodes, 0.5) if np.isinf(alpha)
         else rng0.beta(alpha, alpha, size=n_nodes))
    # Bayes-optimal separator of the pooled (label-balanced in expectation)
    # mixture
    prior = float(np.mean(p))
    w = (mus[1] - mus[0]) / cfg.noise_var
    b = (-(np.sum(mus[1] ** 2) - np.sum(mus[0] ** 2)) / (2 * cfg.noise_var)
         + np.log(prior / max(1.0 - prior, 1e-12)))
    w_star = np.concatenate([w, [b]]).astype(np.float32)
    sig = np.sqrt(cfg.noise_var)

    def sample(rng: "np.random.Generator", n: int):
        xs, ys = [], []
        for i, idx in enumerate(np.array_split(np.arange(n), n_nodes)):
            c = len(idx)
            y = np.where(rng.random(c) < p[i], 1.0, -1.0).astype(np.float32)
            mu = np.where(y[:, None] > 0, mus[1], mus[0])
            x = mu + sig * rng.standard_normal((c, cfg.dim))
            xs.append(x.astype(np.float32))
            ys.append(y)
        return {"x": np.concatenate(xs), "y": np.concatenate(ys)}

    return SkewedLogRegStream(sample, w_star, p.astype(np.float64),
                              float(alpha), n_nodes)
