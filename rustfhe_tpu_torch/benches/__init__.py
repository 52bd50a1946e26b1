"""The port's measurement probes and studies on the card: counterparts of
the JAX package's ``benches/`` scripts.

Each runs as ``python -m rustfhe_tpu_torch.benches.<name> [B] [which ...]``
on a host with a CUDA device, with the JAX script's arguments and
defaults:

* ``step_breakdown_probe``: the limb step split by ablation (P6: K6's
  int8 ``wgmma`` step without its rotation or its products) and the bare
  int8 dot tile (P7), beside K4 and K6;
* ``limb_order_probe``: the merged step's two recombination orders (P5:
  K4's step, the product draining per plane or once), beside K4;
* ``matmul_probe``: the blocked int8 GEMM at the external product's shape
  (P9), beside ``torch._int_mm``;
* ``k2_floor_probe``: the two-level Karatsuba step (K1's function in the
  residue layout) by ablation (P4), with the attribution;
* ``vpu_reduce_probe``: its digit-side variants and two steps per call
  (P8), beside K1;
* ``karatsuba2_probe``: its limb-outer form (P1) beside K1;
* ``coissue_probe``: its leaf product's block tile as two sub-tiles, in
  turn or together (P2);
* ``coissue2_probe``: where its sum leaves' tree planes are built (P3).

The studies that time no kernel of their own, each with a ``run(out=print,
...)`` (its checks run on any device; its timings need the card):

* ``multibit_probe``: the grouped (k=2) blind rotation, built exactly,
  against the standard scan on "matmul" (P9) and "cmux_k" (K2);
* ``keyswitch_probe``: the identity key switch in seven forms, the
  float64 mask GEMMs against the int8 one-hot product on P9;
* ``latency_probe``, ``repl_latency_probe``, ``pipeline_repl_probe``:
  the latency of one batch, of one console gate per key mode, and of the
  console's pipelined sessions (K1, K3, the hybrid key);
* ``unroll_probe``, ``hybrid_unroll_probe``: the panel build's share of a
  step (P8, K1) and the whole rotation on prebuilt odd-step panels;
* ``n2048_probe``, ``karatsuba_probe``: K1 (and P4) exact against the
  composed "matmul" step, then timed (with K4);
* ``nuss_transform_probe``: the transform-domain product exact, its
  stages as int8 GEMMs on P9;
* ``noise_calibration_probe``: the noise model against wrong decodes
  counted on K1;
* ``optimizer_probe``, ``adder_ab_probe``: the circuit optimizer's A/B and
  the adder cells' on the level-fused evaluator;
* ``kernels``: the bootstrap's stages each beside its bound.
"""
