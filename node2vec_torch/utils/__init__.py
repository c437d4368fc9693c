"""Host utilities of the port (checkpoint files)."""
