"""The serving runtime: the staged streaming executor and the ``Engine``
facade over it (the counterpart of ``repro.runtime``)."""
