"""Simulator core of the PyTorch port."""
