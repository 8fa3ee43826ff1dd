"""Checkpoints, run logs, metrics, the plateau scheduler, tracing and the
port's host spans (``profiling``) and the FLOPs of a train step
(``flops``)."""
