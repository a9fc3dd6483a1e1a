"""PyTorch/CUDA port of `repro`: the paper's streaming D(M)-Krasulina PCA on
the governed superstep driver, with hand-written Hopper kernels for the hot
path (`kernels/csrc/`).

The layout mirrors `src/repro` module by module. The package imports torch,
numpy and the standard library only — never jax, never `repro` — so it loads
on a machine without JAX. Entry points take an explicit `device`; `None`
means the CUDA card, and a machine without one raises instead of quietly
running on the CPU (pass `device="cpu"` for the plain PyTorch path).
"""
