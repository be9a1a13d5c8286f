"""Command-line interface of the port."""
