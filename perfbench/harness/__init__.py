"""The benchmark's yardstick: loading cells, traffic, weights, traces, peaks
and the comparison that decides ``correct``."""
