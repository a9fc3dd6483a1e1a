"""Governed streaming pipeline, device prefetch ring and synthetic streams."""
