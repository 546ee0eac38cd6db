"""The native tool-calling agent: Hermes markup, the tool registry, the
web-search backends and the agent loop that runs the tools in-stream."""

from fasttalk_tpu_torch.agents.hermes import (
    HermesStreamParser,
    ToolCall,
    format_tool_result,
    tools_system_prompt,
)
from fasttalk_tpu_torch.agents.tools import (
    OfflineSearchBackend,
    RateLimiter,
    Tool,
    ToolRegistry,
    WebSearchBackend,
    build_default_registry,
)
from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent

__all__ = [
    "HermesStreamParser", "ToolCall", "format_tool_result",
    "tools_system_prompt",
    "OfflineSearchBackend", "RateLimiter", "Tool", "ToolRegistry",
    "WebSearchBackend", "build_default_registry", "VoiceAgent",
]
