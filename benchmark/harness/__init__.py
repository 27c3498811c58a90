"""The harness: discovery, the traffic generator, the trace reduction,
the arithmetic and the comparison that decides ``correct``."""
