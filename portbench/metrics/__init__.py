"""Per-layer metric readers: ``<name>.py`` holds ``read(ctx)``, which takes
the metric from the traced window (``ctx['trace']``, a
``common.trace.Trace``) and returns its value, or None where the trace
holds nothing to read. Shared arithmetic is in ``portbench.common.read``."""
