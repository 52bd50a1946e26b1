"""Sampling helpers (counterpart of ``rustfhe_tpu/utils``)."""
