"""Benchmark harnesses."""
