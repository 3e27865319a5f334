"""5 Hz planner LM: constrained decoding, sampling, prefix cache, handler."""
