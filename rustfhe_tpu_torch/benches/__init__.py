"""The port's measurement probes on the card: counterparts of the JAX
package's ``benches/`` probes whose kernels the port carries.

Each runs as ``python -m rustfhe_tpu_torch.benches.<name> [B] [which ...]``
on a host with a CUDA device, with the JAX script's arguments and
defaults:

* ``step_breakdown_probe``: the limb step split by ablation (P6, the
  step's ``__dp4a`` form) and the bare int8 dot tile (P7), beside K4 and
  K6 (the int8 ``wgmma`` GEMM);
* ``limb_order_probe``: the merged step's two recombination orders (P5,
  the ``__dp4a`` form), beside K4;
* ``matmul_probe``: the blocked int8 GEMM at the external product's shape
  (P9), beside ``torch._int_mm``;
* ``k2_floor_probe``: the two-level Karatsuba step (K1's function in the
  residue layout) by ablation (P4), with the attribution;
* ``vpu_reduce_probe``: its digit-side variants and two steps per call
  (P8), beside K1;
* ``karatsuba2_probe``: its limb-outer form (P1) beside K1;
* ``coissue_probe``: its block tile as two sub-tiles, serial or grouped (P2).
"""
