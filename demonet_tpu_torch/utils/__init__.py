"""Weights carried across from the JAX package."""
