"""One-sided verb plans."""
