"""Drivers of the port (counterpart of the repository's ``examples/``),
kept inside the package."""
