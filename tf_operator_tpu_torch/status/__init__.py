"""Status surfaces of the port's pods (metrics)."""
