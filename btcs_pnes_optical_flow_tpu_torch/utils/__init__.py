"""Timing, profiling and logging (``timing``)."""
