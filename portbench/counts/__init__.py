"""Frozen counts of work: model FLOPs and each kernel family's FLOPs and
bytes, from a configuration's shapes alone."""
