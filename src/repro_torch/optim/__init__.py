"""Wire compression for the simulated reductions."""
