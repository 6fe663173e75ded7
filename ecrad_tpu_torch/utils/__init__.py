"""Utilities of the port (torch only)."""
