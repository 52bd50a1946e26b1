"""Ports of the repository's ``examples/`` scripts, each run as a module
(``python3 -m rustfhe_tpu_torch.examples.<name>``)."""
