"""Precision policy."""
