"""Run observability. Only the warn-once dedupe (``events``) so far."""
