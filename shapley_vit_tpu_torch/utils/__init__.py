"""Logging and profiling utilities."""
