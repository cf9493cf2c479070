"""Execution backends of the port."""
