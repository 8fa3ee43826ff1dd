"""Checkpoints, run logs, metrics, the plateau scheduler, tracing and
timing (``profiling``) and the FLOPs of a train step (``flops``)."""
