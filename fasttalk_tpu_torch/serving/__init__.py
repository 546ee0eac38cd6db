"""The WebSocket server (``/ws/llm``) and per-session conversations."""
