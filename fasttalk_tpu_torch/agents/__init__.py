"""Client tool calls in the Hermes markup (the server-driven tool loop is not ported)."""
