"""The yardstick: spec loading, traffic generation, tracing, the judge and
the arithmetic of the metrics. Nothing here is the program under test."""
