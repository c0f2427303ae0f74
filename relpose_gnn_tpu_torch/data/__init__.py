"""Input normalisation."""
