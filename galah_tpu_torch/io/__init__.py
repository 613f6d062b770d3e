"""Host input parsing for the port."""
