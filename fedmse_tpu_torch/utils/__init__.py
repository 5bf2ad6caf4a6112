"""Host utilities of the port: seeding of its random streams, phase timing
and tracing, artifact provenance, and the float64 similarity scores."""
