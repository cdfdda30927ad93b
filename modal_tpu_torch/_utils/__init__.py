"""Helpers shared by the port's runtime and server modules."""
