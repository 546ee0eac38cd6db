"""FastTalk on PyTorch and CUDA: the port of ``fasttalk_tpu`` to one NVIDIA
H100.

The JAX package ``fasttalk_tpu`` stays the reference; this package imports
nothing of it. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Run the WebSocket server with
``python -m fasttalk_tpu_torch websocket``.
"""

__version__ = "0.1.0"
