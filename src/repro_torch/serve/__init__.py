"""Serving on the port: static generate and continuous batching."""
