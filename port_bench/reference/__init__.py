"""Plain references of the benchmark's configurations: numpy and plain
torch only, built from the configuration's numbers alone."""
