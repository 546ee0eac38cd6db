"""Operational observability: the bounded event log."""
