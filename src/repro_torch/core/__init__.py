"""The paper's algorithms, rate model, consensus engine and streaming governor."""
