"""Host input front of the port (framing workers, byte-range splits)."""
