"""The benchmark's harness: finds a cell's files by name, runs its driver,
reads per-layer metrics from the trace and prints the result line."""
