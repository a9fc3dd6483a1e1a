"""The paper's synthetic PCA streams (Figs. 7-8): spiked / power-law
covariance with lambda_1 = 1 and a prescribed eigengap.

Two sources of the same stream:

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
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.paper_pca import PCAConfig
from repro_torch.device import DeviceLike, resolve_device


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
