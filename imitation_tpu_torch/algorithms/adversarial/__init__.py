"""Adversarial imitation (GAIL)."""
