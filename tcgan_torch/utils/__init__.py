"""Shared utilities (timing, profiler traces)."""
