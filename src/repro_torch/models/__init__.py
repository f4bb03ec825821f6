"""Layers, the vision backbone and the parameter carrier from the reference."""
