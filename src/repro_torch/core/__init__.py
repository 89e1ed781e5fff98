"""Quantization, SEU injection, ABFT, NMR voting, the dependability policy
layer and the execution-backend registry (the counterpart of ``repro.core``)."""
