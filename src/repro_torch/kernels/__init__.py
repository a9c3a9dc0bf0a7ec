"""Segment kernels (CUDA for Hopper) and their plain versions."""
