"""Retrieval: descriptor index and neighbour subsampling."""
