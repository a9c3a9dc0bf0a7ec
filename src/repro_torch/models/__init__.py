"""Decoder-LM substrate of the port: config, layers, the dense transformer."""
