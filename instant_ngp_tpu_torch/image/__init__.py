"""Image mode: fit a neural field to a 2D image (counterpart of
instant_ngp_tpu/image)."""
