"""KV-cache bookkeeping of the port: the paged tier's block allocator
(blocks.py), the radix prefix cache over it (radix.py) and the session
host-offload tier (hostpool.py, policy.py, offload.py)."""
