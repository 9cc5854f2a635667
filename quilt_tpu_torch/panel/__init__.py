"""Device-side pieces of the reference-panel search of the port."""
