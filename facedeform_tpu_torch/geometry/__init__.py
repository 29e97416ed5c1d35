"""Procedural geometry for tests and benchmarks."""
