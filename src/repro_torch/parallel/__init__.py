"""Parallelism on ``torch.distributed``: the collectives and the sharding
specs (the counterpart of ``repro.parallel``; its pipeline waits for
ROADMAP.md queue 1, item 17)."""
