"""File input for the port (numpy only)."""
