"""The port's LM assembly: the attention-based decoders (layers, moe,
transformer, registry)."""
