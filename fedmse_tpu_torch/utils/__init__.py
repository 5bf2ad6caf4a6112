"""Seeding of the port's random streams."""
