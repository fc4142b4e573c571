"""Command-line entry points: train and evaluate."""
