"""Artifact writers: image grids and the Pareto scatter."""
