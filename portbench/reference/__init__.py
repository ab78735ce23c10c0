"""The plain float64 reference the benchmark's checks hold the port to."""
