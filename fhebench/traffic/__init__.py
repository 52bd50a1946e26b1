"""Traffic: the mixes (``<mix>.json``) and their generators (``<generator>.py``)."""
