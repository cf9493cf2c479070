"""Communication graphs."""
