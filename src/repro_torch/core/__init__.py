"""Hashing, cost accounting and the continuity table."""
