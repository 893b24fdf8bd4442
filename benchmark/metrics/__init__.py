"""One reader a metric: ``<metric name>.py`` with ``read(run)``, which
returns the metric's value from a ``harness.cell.Run``, or None when the
run holds nothing to read (the metric is then left out of the line)."""
