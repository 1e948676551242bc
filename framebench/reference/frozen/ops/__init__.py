"""Frozen stages; see the package docstring."""
