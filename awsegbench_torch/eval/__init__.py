"""The eval step of the benchmark."""
