"""The paper's streaming 1-PCA experiment (Section IV-D).

Fig. 7: Sigma in R^{10x10}, lambda_1 = 1, eigengap 0.1, t' = 1e6 Gaussian samples.
Fig. 8: CIFAR-10 (d=3072). CIFAR is not bundled offline; `HIGHD` reproduces the
regime with a synthetic spiked-covariance dataset of the same dimension and a
comparable spectral profile (documented deviation, docs/DESIGN.md §Deviations).
"""
from dataclasses import dataclass, field

from repro_torch.configs.base import AveragingConfig, StreamConfig


@dataclass(frozen=True)
class PCAConfig:
    dim: int = 10
    eigengap: float = 0.1
    lambda1: float = 1.0
    spectrum: str = "linear"  # linear decay below lambda_2
    seed: int = 0


FIG7 = PCAConfig(dim=10, eigengap=0.1)
HIGHD = PCAConfig(dim=3072, eigengap=0.3, lambda1=1.0, spectrum="power")


@dataclass(frozen=True)
class PCARunConfig:
    """Distribution setup for the PCA track on the streaming engine: the
    subset of `RunConfig` that `train.driver.StreamingDriver` consumes
    (`.averaging` for the consensus engine / node split, `.stream` for the
    governor's rate model), with the PCA problem in place of a ModelConfig.
    Pair it with `core.krasulina.build_krasulina_superstep` as the driver's
    `superstep_fn`."""

    pca: PCAConfig = FIG7
    averaging: AveragingConfig = field(default_factory=AveragingConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
