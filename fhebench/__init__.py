"""The benchmark of ``rustfhe_tpu_torch``, the PyTorch and CUDA port.

``python3 -m fhebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix, traffic generator or metric is a file of its own, found by
name: ``configs/<config>.json``, ``traffic/<mix>.json`` (which names its
generator, ``traffic/<generator>.py``), ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  The plain reference that decides ``correct``
is ``reference/``.  Nothing here imports jax or the JAX package.
"""
