"""One reader a metric: ``read(run) -> float | None`` takes the run's
record (``run.Run``) and returns the metric, or None where the run has
nothing to read it from; the harness then leaves it out of the line."""
