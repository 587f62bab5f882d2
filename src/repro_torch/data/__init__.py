"""Deterministic synthetic datasets."""
