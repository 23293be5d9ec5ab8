"""Deterministic synthetic token streams (numpy)."""
