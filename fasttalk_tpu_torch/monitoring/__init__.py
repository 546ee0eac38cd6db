"""The monitoring app served on its own port (monitor.py)."""
