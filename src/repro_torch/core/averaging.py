"""Gradient-averaging operators — this slice ports the consensus-engine
builder `make_gossip_mix`, which the PCA track needs. The tree-level
averaging modes (packed gossip, hierarchical reduce-scatter, error feedback)
come with the LM slice, beside `core/packing.py` and `core/quantize.py`.
"""
from __future__ import annotations

from repro_torch.configs.base import AveragingConfig
from repro_torch.core.mixing import CirculantMixOp, circulant_mix_op, schedule
from repro_torch.device import DeviceLike


def make_gossip_mix(cfg: AveragingConfig, n_nodes: int, *,
                    impl: str = "auto",
                    device: DeviceLike = None) -> CirculantMixOp:
    """Build the consensus engine for a config — once, outside the step loop.

    `impl="auto"` resolves per device (`core.mixing.resolve_auto_impl`): the
    CUDA kernel on the card, the dense circulant matmul on the CPU.
    Quantized wires and error feedback belong to later slices and raise."""
    if cfg.error_feedback != "off":
        raise NotImplementedError(
            "error-feedback compressed gossip comes with the port's LM slice")
    sched = schedule(cfg.topology, n_nodes, cfg.self_weight)
    return circulant_mix_op(sched, n_nodes, cfg.rounds,
                            quantization=cfg.quantization, impl=impl,
                            device=device)
