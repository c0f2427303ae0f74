"""Serving-path evaluation."""
