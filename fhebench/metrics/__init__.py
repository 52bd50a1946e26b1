"""Metric readers: ``<metric>.py`` holds ``read(run)``, which returns a number or
None when it finds nothing to read."""
