"""High-level TFHE context: the user-facing object API.

Counterpart of ``rustfhe_tpu/context.py`` (keygen, the latency mode, the
key cache, encrypt/decrypt and the seeded upload, the gate set, the
typed-integer and radix constructors, the programmable-bootstrapping
methods and public-key encryption).  Randomness comes from one
``torch.Generator`` on the context's device, used for keygen and then for
every encryption; a seeded upload's mask comes from threefry
(``utils/threefry.py``) under a key drawn from that generator.  A
cloud-only context has no generator: it encrypts under a public key with
one the caller passes, as the JAX package's takes an explicit PRNG key.
"""

from __future__ import annotations

import torch

from . import gates, pbs, tlwe, torus
from ._device import resolve_device
from ._u32 import from_numpy
from .engine import resolve_engine, select_engine
from .ints import FheInt, FheUint, from_pbs_int
from .radix import RadixInt, RadixUint
from .keys import CloudKey, SecretKey, cloud_key_latency, gen_keys
from .params import DEFAULT_PARAMS, TFHEParams


class TFHE:
    """Keyed TFHE evaluator on one device.

    >>> ctx = TFHE.new(0, params)  # on the CUDA card; device="cpu" for the CPU
    >>> c = ctx.encrypt(torch.tensor([0, 1, 1, 0]))
    >>> bits = ctx.decrypt(ctx.nand(c, c))
    """

    def __init__(self, sk: SecretKey | None, ck: CloudKey, params: TFHEParams,
                 device, gen: torch.Generator | None = None, engine_name: str = ""):
        self.sk = sk
        self.ck = ck
        self.params = params
        self.device = torch.device(device)
        self.gen = gen
        self.engine_name = engine_name

    @classmethod
    def new(cls, seed_or_generator, params: TFHEParams = DEFAULT_PARAMS,
            device="cuda", latency_mode: bool = False,
            keyfile: str | None = None, engine_name=None) -> "TFHE":
        """Keygen on ``device`` (the CUDA card unless the caller names the
        CPU) from an int seed or a ``torch.Generator`` that lives there.
        The engine is admitted on the device first (``engine.select_engine``:
        its external product against the oracle), and a CUDA device that
        is not available raises.

        ``engine_name``: ``None`` picks the engine by the JAX package's
        accelerator rule (``engine.engine_for``), as its
        ``TFHE.new(engine_name=None)`` does: ``"cmux_k"`` (K1-K3) where N
        tiles by 512 or 256 and Bg <= 2^5 or 2^6, ``"limb"`` (K4-K6) where
        N tiles by 128 and Bg <= 2^8 (FAST_PARAMS), else ``"matmul"`` (the
        int8 GEMM; TEST_PARAMS, N=64) while Bg <= 2^8, then
        ``"matmul_bf16"``.  The JAX package's own default is ``"matmul"``;
        this one stays the rule, so DEFAULT_PARAMS runs K1.  A name
        (``"matmul"``, ``"matmul_bf16"``, ``"fft64"``, ``"cmux_k"``,
        ``"limb"``) or an engine instance (``engine.LimbEngine(merge_c=
        False)``) is honoured; ``"nuss"`` passes the probe but has no cloud
        key (``keys.prepare_cloud_key``).  The keys and every encryption
        draw the same random words for any engine.

        ``latency_mode`` marks the bootstrapping key for the single-launch
        rotation K3 (``keys.cloud_key_latency``): small batches, as an
        interactive console evaluates, run one kernel launch per blind
        rotation instead of n.  It adds no memory.
        ``keyfile``: path prefix of the on-disk raw-key cache
        (``utils.serialization.cached_keys``): keygen runs once, later
        contexts load the keys.  A cached context reuses the same secret
        key across runs."""
        device = resolve_device(device)
        if isinstance(seed_or_generator, torch.Generator):
            gen = seed_or_generator
            if gen.device.type != device.type:
                raise ValueError(f"generator is on {gen.device}, context on {device}")
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed_or_generator))
        name = select_engine(params, device, engine_name)
        engine = resolve_engine(engine_name or name)
        if keyfile:
            from .utils.serialization import cached_keys

            sk, ck = cached_keys(keyfile, gen, params, device, verbose=True, engine=engine)
        else:
            sk, ck = gen_keys(gen, params, device, engine)
        if latency_mode:
            ck = cloud_key_latency(ck)
        return cls(sk, ck, params, device, gen, name)

    # -------------------------- client side --------------------------- #
    def _bits(self, bits) -> torch.Tensor:
        return torch.as_tensor(bits).to(device=self.device, dtype=torch.int32)

    def encrypt(self, bits) -> torch.Tensor:
        """bits: {0,1} array (...,) -> TLWE batch (..., n+1)."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return tlwe.encrypt_binary(self.gen, self.sk.lv0, self._bits(bits), self.params)

    def decrypt(self, cts: torch.Tensor) -> torch.Tensor:
        if self.sk is None:
            raise ValueError("cloud-only context cannot decrypt")
        return tlwe.decrypt_binary(cts, self.sk.lv0)

    def encrypt_seeded(self, bits) -> tuple[torch.Tensor, torch.Tensor]:
        """Compressed client->server form: ``(seed (2,) int32 words,
        bodies)``, (n+1)x smaller than ``encrypt`` on the wire; any party
        (a cloud-only context too) expands it with ``expand_seeded``, in
        this package or the JAX one (tlwe.encrypt_binary_seeded)."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return tlwe.encrypt_binary_seeded(self.gen, self.sk.lv0, self._bits(bits), self.params)

    def expand_seeded(self, seeded) -> torch.Tensor:
        """(seed, bodies) -> the full TLWE batch on the context's device;
        public, works cloud-only.  A (seed, bodies) pair of the JAX package
        (numpy uint32) expands to its ciphertext word for word."""
        seed, b = seeded
        return tlwe.expand_seeded(seed, b, self.params.n, self.device)

    def make_public_key(self, rows: int | None = None) -> torch.Tensor:
        """Publishable encryption key, int32 (M, n+1): zero-encryptions
        under the secret key (``tlwe.gen_public_key``; M = 2(n+1) unless
        ``rows`` says).  Keyless parties then encrypt with
        ``encrypt_public``."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot derive a public key")
        return tlwe.gen_public_key(self.gen, self.sk.lv0, self.params, rows)

    def encrypt_public(self, pk, bits, gen: torch.Generator | None = None) -> torch.Tensor:
        """Encrypt bits under the PUBLIC key ``pk`` (int32 (M, n+1), or the
        JAX package's numpy uint32 words): no secret material
        (``tlwe.encrypt_binary_public``, the dual-Regev form).  Works on a
        cloud-only context, which needs an explicit ``gen``, a
        ``torch.Generator`` on the context's device."""
        gen = gen if gen is not None else self.gen
        if gen is None:
            raise ValueError("no encryption generator (cloud-only context): pass gen=")
        if gen.device.type != self.device.type:
            raise ValueError(f"generator is on {gen.device}, context on {self.device}")
        pk = pk.to(self.device) if isinstance(pk, torch.Tensor) else from_numpy(pk, self.device)
        return tlwe.encrypt_binary_public(gen, pk, self._bits(bits), self.params)

    def trivial(self, bits) -> torch.Tensor:
        """Noiseless ciphertexts of constants."""
        return tlwe.trivial(torus.binary_to_torus(self._bits(bits)), self.params.n)

    def cloud_only(self) -> "TFHE":
        """Drop the secret key and the generator: the evaluator-side view."""
        return TFHE(None, self.ck, self.params, self.device, None, self.engine_name)

    # -------------------------- gate set ------------------------------ #
    def bootstrap_raw(self, pre: torch.Tensor) -> torch.Tensor:
        """Bootstrap a pre-combined batch."""
        return gates.hom_bootstrap(self.ck, pre, params=self.params)

    def _gate(self, op: str, *cts) -> torch.Tensor:
        """``gates.gate_circuit``, the composition of ``gates.hom_*``, with
        every bootstrap through ``bootstrap_raw`` (one place to count
        them)."""
        return gates.gate_circuit(op, cts, params=self.params, boot=self.bootstrap_raw)

    def nand(self, x, y):
        return self._gate("nand", x, y)

    def and_(self, x, y):
        return self._gate("and", x, y)

    def or_(self, x, y):
        return self._gate("or", x, y)

    def xor(self, x, y):
        return self._gate("xor", x, y)

    def not_(self, x):
        return self._gate("not", x)

    def mux(self, control, in0, in1):
        """(in1 & control) | (in0 & !control): the two independent ANDs run
        as one double-width bootstrap batch, then one OR pass."""
        return self._gate("mux", control, in0, in1)

    # ----------------------- typed integers --------------------------- #
    # ``ints.FheUint`` reads two optional attributes of the context, as in
    # the JAX package: ``circuit_fixed_width`` (pad every circuit level to
    # this width) and ``circuit_adder`` ("kogge_stone", the default, or
    # "ripple").
    def encrypt_uint(self, values, width: int):
        """Encrypt unsigned integers -> batched ``FheUint`` (ints.py)."""
        return FheUint.encrypt(self, values, width)

    def encrypt_sint(self, values, width: int):
        """Encrypt signed integers -> batched ``FheInt`` (two's complement)."""
        return FheInt.encrypt(self, values, width)

    def trivial_uint(self, values, width: int):
        return FheUint.trivial(self, values, width)

    def trivial_sint(self, values, width: int):
        return FheInt.trivial(self, values, width)

    def int_to_uint(self, cts, space: int, *, unsafe: bool = False):
        """PBS-domain encrypted int -> FheUint bit planes, one bootstrap
        level (ints.from_pbs_int: multi-output PBS with raw +-mu tables).
        Raises when the calibrated (space, t) noise margin is below
        threshold unless ``unsafe=True``."""
        return from_pbs_int(self, cts, space, unsafe=unsafe)

    def encrypt_radix(self, values, ndigits: int):
        """Encrypt unsigned integers in radix form (radix.RadixUint: 2-bit
        PBS digits; an add costs one bootstrap level per digit instead of
        the bit circuit's per gate level).  Use params.PBS_PARAMS."""
        return RadixUint.encrypt(self, values, ndigits)

    def trivial_radix(self, values, ndigits: int):
        return RadixUint.trivial(self, values, ndigits)

    def encrypt_radix_signed(self, values, ndigits: int):
        """Signed (two's complement) radix integers (radix.RadixInt)."""
        return RadixInt.encrypt(self, values, ndigits)

    # ------------------ programmable bootstrapping -------------------- #
    def encrypt_int(self, x, space: int) -> torch.Tensor:
        """Encrypt ints in [0, space) (padding-bit encoding; pbs.py)."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return pbs.encrypt_int(self.gen, self.sk.lv0, x, space, self.params)

    def decrypt_int(self, cts: torch.Tensor, space: int) -> torch.Tensor:
        if self.sk is None:
            raise ValueError("cloud-only context cannot decrypt")
        return pbs.decrypt_int(cts, self.sk.lv0, space)

    def apply_lut(self, cts: torch.Tensor, table, space: int) -> torch.Tensor:
        """Programmable bootstrap: cts of x -> cts of table[x] (pbs.pbs).

        ``table``: (space,) ints, or (..., space) for a different function
        per batch row.  One bootstrap of cost; the output noise is reset."""
        return pbs.pbs(self.ck, cts, table, space=space, params=self.params)

    def apply_luts(self, cts: torch.Tensor, tables, space: int) -> torch.Tensor:
        """Multi-output PBS (pbs.pbs_many): ``tables (..., t, space)`` ->
        ``(..., t, n+1)``, all t lookups from one blind rotation."""
        return pbs.pbs_many(self.ck, cts, tables, space=space, params=self.params)
