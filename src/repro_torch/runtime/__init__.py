"""The runtime: the staged streaming executor and the serving ``Engine``
facade over it, the orchestrator, and the fault-tolerant training loop
(the counterpart of ``repro.runtime``)."""
