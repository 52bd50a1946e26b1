"""Sampling helpers, threefry, the noise model and (de)serialization
(counterpart of ``rustfhe_tpu/utils``)."""
