"""Developer entry points of the port (kernel probes)."""
