"""Shared utilities (timing)."""
