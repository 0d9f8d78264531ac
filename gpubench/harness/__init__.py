"""The harness: the stream, the runs, the metrics, the trace and the
check against the reference."""
