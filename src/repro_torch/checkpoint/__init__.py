"""Checkpoints: npz groups plus a manifest, written asynchronously."""
