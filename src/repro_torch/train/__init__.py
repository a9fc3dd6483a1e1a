"""The streaming superstep driver."""
