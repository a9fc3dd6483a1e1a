"""The port's LM assembly: dense GQA decoder (layers, transformer, registry)."""
