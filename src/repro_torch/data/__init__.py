"""Synthetic datasets and the LM batch loader."""
