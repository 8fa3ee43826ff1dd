"""The harness: data, spans, trace reading, the run and the check."""
