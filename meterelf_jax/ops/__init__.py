"""Compute ops: cv2-parity kernels in jax.numpy/lax (color, template
match, morphology, components, angles, JPEG back-half)."""
