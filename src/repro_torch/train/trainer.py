"""Trainer helpers the streaming driver needs. This slice ports the node
split of the splitter; the LM trainer itself comes with the LM slice."""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_node_batch(batch: Dict[str, np.ndarray], n_nodes: int,
                    axis: int = 0) -> Dict[str, np.ndarray]:
    """[B, ...] -> [n_nodes, B/n_nodes, ...] (the splitter of Fig. 3(c)).
    `axis=1` splits superstep batches [K, B, ...] -> [K, n_nodes, B/n_nodes, ...].
    Works on numpy arrays and torch tensors alike (a reshape of each leaf)."""
    def split(a):
        shp = a.shape
        return a.reshape(*shp[:axis], n_nodes, shp[axis] // n_nodes,
                         *shp[axis + 1:])
    return {k: split(v) for k, v in batch.items()}
