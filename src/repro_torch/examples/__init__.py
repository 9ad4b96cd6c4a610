"""Twins of the reference's ``examples/`` scripts, inside the port's package."""
