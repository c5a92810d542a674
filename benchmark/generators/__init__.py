"""See the package docstring of ``benchmark``."""
