"""The paper's own convex experiment: binary logistic regression (Sections IV-B, V-C).

Two data generators are used by the paper:
  - Fig. 6: w* ~ N(0,I), x ~ N(0,I_d) with d=5, Bernoulli labels via the logistic link.
  - Fig. 9: conditional Gaussians, d=20, sigma_x^2=2, class means ~ N(0, I).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class LogRegConfig:
    dim: int = 5
    generator: str = "logistic_link"  # logistic_link | cond_gauss
    noise_var: float = 2.0  # sigma_x^2 for cond_gauss
    seed: int = 0


FIG6 = LogRegConfig(dim=5, generator="logistic_link")
FIG9 = LogRegConfig(dim=20, generator="cond_gauss", noise_var=2.0)
