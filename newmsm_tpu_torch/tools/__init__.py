"""Standalone command-line tools."""
