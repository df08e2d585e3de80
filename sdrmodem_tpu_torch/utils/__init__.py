"""Helpers around the port: state conversion to and from numpy."""
