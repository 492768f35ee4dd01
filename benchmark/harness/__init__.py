"""The benchmark's general machinery: environment, inputs, weights, traces, checks."""
