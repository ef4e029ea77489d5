"""Scripted experts for testing."""
