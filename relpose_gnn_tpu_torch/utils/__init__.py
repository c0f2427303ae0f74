"""Logging and metrics helpers of the port (its own copies)."""
