"""Segmentation metrics."""
