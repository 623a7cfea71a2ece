"""Datasets, the loader and the synthetic fixtures."""
