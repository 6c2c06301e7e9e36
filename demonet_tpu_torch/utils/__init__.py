"""Weights carried across from the JAX package, checkpoints, backbone
freezing, and training logs."""
