"""Research analyses on the port: sensitivity sweeps, their figures and comparisons."""
