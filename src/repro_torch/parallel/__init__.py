"""Parallelism on ``torch.distributed``: the collectives, the sharding
specs and the stage pipeline (the counterpart of ``repro.parallel``)."""
