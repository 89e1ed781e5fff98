"""Deterministic token streams for training."""
