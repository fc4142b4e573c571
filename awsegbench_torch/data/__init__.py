"""Device-side batch preparation."""
