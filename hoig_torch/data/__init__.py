"""Synthetic fixtures."""
