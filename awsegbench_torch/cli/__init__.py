"""Command-line entry points: train, evaluate and export_serving."""
