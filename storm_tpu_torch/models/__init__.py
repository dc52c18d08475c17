"""Model layer: wav <-> spec plumbing and the StoRM model."""
