"""Predict step."""
