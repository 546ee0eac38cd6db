"""Admission control: the bounded, deadline-aware request scheduler."""
