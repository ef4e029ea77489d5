"""Imitation algorithms."""
