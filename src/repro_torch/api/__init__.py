"""Public surface of the port; this slice carries the problem registry."""
