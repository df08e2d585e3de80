"""Helpers around the port: state conversion to and from numpy, and the
spans and counters a profiled run records (``spans.py``)."""
