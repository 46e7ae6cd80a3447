"""The plain reference: PyTorch only, float32, independent of the program
(it imports nothing of `instant_ngp_tpu_torch`, nor JAX)."""
