"""Carry the JAX package's numbers (as numpy) into the port's objects, so
both packages can compute the same thing from the same numbers — a
`KrasulinaState`, a `PCAStream` built from the reference's covariance, and a
circulant schedule. Nothing here imports the JAX package: callers pass
`np.asarray(...)` of its arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.krasulina import KrasulinaState
from repro_torch.core.mixing import Schedule
from repro_torch.data.synthetic import PCAStream
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


def schedule(sched) -> Schedule:
    """A circulant schedule with plain Python numbers."""
    return tuple((int(s), float(w)) for s, w in sched)
