"""Kernels (CUDA for Hopper): segment probe, mutation plan, paged attention;
and their plain versions."""
