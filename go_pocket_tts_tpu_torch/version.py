"""Package version."""

__version__ = "0.1.0"
