"""Errors, health checks and the float32 precision scope."""
