"""The harness: finding cells, configurations, drivers and metrics by
name, the measured window, the trace reduction and the peaks."""
