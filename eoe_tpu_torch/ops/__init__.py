"""Operators of the port: the fused attention kernel, preprocessing, scores, metrics."""
