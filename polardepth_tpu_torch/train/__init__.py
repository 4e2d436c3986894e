"""Serving of the port: batch preprocessing and the inference step."""
