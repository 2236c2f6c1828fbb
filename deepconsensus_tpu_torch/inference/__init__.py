"""Serial inference runner."""
