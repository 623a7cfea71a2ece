"""Inference-path training glue: configs, generator inputs, serving entry points."""
