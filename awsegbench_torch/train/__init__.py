"""Optimiser factories and the benchmark's train step."""
