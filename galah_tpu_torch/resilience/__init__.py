"""Resilience of a long run: the durable-write faults (``faults``),
cooperative preemption (``interrupt``), the host-IO retry (``policy``)
and the quarantine of unreadable genomes (``quarantine``)."""
