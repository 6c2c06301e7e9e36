"""Predict step, train step and epoch loop, train state and LR schedule."""
