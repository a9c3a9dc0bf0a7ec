"""Kernels (CUDA for Hopper): segment probe, mutation plan, paged attention
and the baselines' serial walk; and their plain versions."""
