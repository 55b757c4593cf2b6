"""Optimizers (AdamW, SGD-momentum) and the quantized gradient compressor."""
