"""Resilience of a long run: the device-dispatch supervisor
(``dispatch``: retry and validate a guarded call, then raise), the
retry policy and its classification (``policy``, also the host-IO
retry), seeded fault injection at the dispatch and durable-write sites
(``faults``, ``GALAH_FI``), cooperative preemption (``interrupt``), the
quarantine of unreadable genomes (``quarantine``) and the kill-anywhere
chaos harness (``chaos``, ``python -m
galah_tpu_torch.resilience.chaos``)."""
