"""Research analyses on the port: sensitivity sweeps, statistics, the
science loop, EDA and the research app's figures."""
