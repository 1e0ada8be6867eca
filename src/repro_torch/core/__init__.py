"""The interleaved offload engine of the port and its plan geometry."""
