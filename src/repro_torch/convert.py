"""Carry the JAX package's numbers (as numpy) into the port's objects, so
both packages can compute the same thing from the same numbers — a
`KrasulinaState`, a `PCAStream` built from the reference's covariance, a
`LogRegStream` built from the reference's ground truth, and a circulant
schedule. Nothing here imports the JAX package: callers pass
`np.asarray(...)` of its arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper_logreg import LogRegConfig
from repro_torch.core.krasulina import KrasulinaState
from repro_torch.core.mixing import Schedule
from repro_torch.data.synthetic import LogRegStream, PCAStream
from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device)


def krasulina_state(w, t, *, device: DeviceLike = None) -> KrasulinaState:
    """A superstep carry from the reference's `KrasulinaState(w, t)`."""
    return KrasulinaState(_tensor(w, resolve_device(device)), int(t))


def pca_stream(cov, sqrt_cov, top_eigvec, lambda1: float, eigengap: float, *,
               device: DeviceLike = None) -> PCAStream:
    """A `PCAStream` over the reference stream's covariance: its
    `make_pca_host_sampler` then gives the reference's draws exactly."""
    dev = resolve_device(device)
    return PCAStream(_tensor(cov, dev), _tensor(top_eigvec, dev),
                     float(lambda1), float(eigengap), _tensor(sqrt_cov, dev))


def logreg_stream(cfg: LogRegConfig, w_star, mus=None, *,
                  device: DeviceLike = None) -> LogRegStream:
    """A `LogRegStream` over the reference stream's problem: its `w_star`
    and, for the conditional Gaussians (FIG9), its class means [2, d]. The
    draws then come from the same distribution as the reference's (not the
    same numbers)."""
    dev = resolve_device(device)
    if (mus is None) != (cfg.generator == "logistic_link"):
        raise ValueError(f"the {cfg.generator} generator "
                         f"{'takes no' if mus is not None else 'needs its'} "
                         f"class means")
    return LogRegStream(cfg, _tensor(w_star, dev).float(),
                        None if mus is None else _tensor(mus, dev).float())


def schedule(sched) -> Schedule:
    """A circulant schedule with plain Python numbers."""
    return tuple((int(s), float(w)) for s, w in sched)
