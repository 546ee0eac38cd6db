"""KV-cache bookkeeping of the port (the paged tier's block allocator)."""
