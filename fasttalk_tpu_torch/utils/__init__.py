"""Configuration, logging and error types."""
