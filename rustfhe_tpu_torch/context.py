"""High-level TFHE context: the user-facing object API.

Counterpart of ``rustfhe_tpu/context.py`` (keygen, the latency mode, the
key cache, encrypt/decrypt, the gate set and the typed-integer
constructors; the PBS, radix, seeded and public-key methods are not ported
yet).  Randomness comes from
one ``torch.Generator`` on the context's device, used for keygen and then
for every encryption.
"""

from __future__ import annotations

import torch

from . import gates, tlwe, torus
from ._device import resolve_device
from .engine import resolve_engine, select_engine
from .ints import FheInt, FheUint
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

    def _gate(self, op: str, x, y=None) -> torch.Tensor:
        return self.bootstrap_raw(gates.precombine(op, x, y, params=self.params))

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
        pre_a = gates.precombine("and", control, in1, params=self.params)
        pre_b = gates.precombine("andn", control, in0, params=self.params)
        both = self.bootstrap_raw(torch.stack([pre_a, pre_b]))
        return self._gate("or", both[0], both[1])

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
