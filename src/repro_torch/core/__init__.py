"""Field arithmetic, quantization, the sigmoid surrogate and Lagrange coding."""
