"""Logging, colour maps and profiling of the port."""
