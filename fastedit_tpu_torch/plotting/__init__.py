"""Comparison figures across method configurations (PIL only)."""
