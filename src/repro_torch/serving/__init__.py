"""Serving runtime of the port: hash-indexed paged KV cache, decode engine,
continuous batcher."""
