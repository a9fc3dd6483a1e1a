"""Configs of the port: `base` (copied whole) and the paper's PCA experiment."""
