"""Graph generators, operators and device operator containers."""
