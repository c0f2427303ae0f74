"""Benchmarks of the port, run on the card."""
