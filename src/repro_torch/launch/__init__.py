"""Entry points of the port (serving, training) and its planning tools."""
