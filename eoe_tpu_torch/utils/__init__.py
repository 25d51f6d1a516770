"""Utilities of the port: the run logger."""
