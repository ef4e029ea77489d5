"""Reward networks."""
