"""Client/server key-exchange flows: public-key and seeded-ciphertext demo.

Port of ``examples/client_server.py``.  Three parties:

  * ALICE holds the secret key.  She publishes a PUBLIC KEY
    (zero-encryptions, ``TFHE.make_public_key``) and the cloud key, and
    keeps the secret key private.
  * BOB has no secret material.  He encrypts his input under the public
    key (``encrypt_public``, the dual-Regev form, with his own
    ``torch.Generator``): randomised, it decrypts only for Alice.
  * Alice's own upload travels SEEDED (``encrypt_seeded``): (seed, body),
    (n+1)x smaller on the wire, expanded publicly by the server.
  * The SERVER (a cloud-only context: no secret key) expands the seeded
    upload and computes gates over both parties' ciphertexts.
  * Alice decrypts the result.

Every step is asserted.  It runs on the card at DEFAULT_PARAMS, and on the
CPU at TEST_PARAMS when ``RUSTFHE_FORCE_CPU=1`` is set, as the JAX script
picks the parameters by backend.  Usage:

    python3 -m rustfhe_tpu_torch.examples.client_server
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import bench_device, card_name
from ..context import TFHE
from ..params import DEFAULT_PARAMS, TEST_PARAMS
from ..utils.timing import time_fn


def main() -> None:
    device = bench_device()
    card = card_name(device)
    params = TEST_PARAMS if device.type == "cpu" else DEFAULT_PARAMS
    print(f"params: n={params.n}, N={params.N} ({device.type}: {card})", flush=True)

    # --- Alice: keygen; publish (public key, cloud key), keep sk. -------
    alice = TFHE.new(2026, params, device=device)
    dt, pk = time_fn(alice.make_public_key, iters=1, warmup=0, device=device)
    server = alice.cloud_only()  # what the server receives: NO secret key
    print(f"public key: {pk.shape[0]} zero-encryptions ({pk.nbytes / 1e6:.1f} MB, "
          f"{dt * 1e3:.1f} ms on {card}); cloud key published", flush=True)

    # --- Bob (keyless): public-key encryption of his bits. -------------
    bob_bits = np.array([0, 1, 1, 0])
    bob_gen = torch.Generator(device=device).manual_seed(7)
    bob_cts = server.encrypt_public(pk, bob_bits, gen=bob_gen)
    print("bob encrypted under pk (no secret material)", flush=True)

    # --- Alice: seeded upload, (n+1)x smaller than full ciphertexts. ---
    alice_bits = np.array([0, 0, 1, 1])
    seed, body = alice.encrypt_seeded(alice_bits)
    full_words = body.numel() * (params.n + 1)
    sent_words = seed.numel() + body.numel()
    print(f"alice's upload: {sent_words} words seeded vs {full_words} full "
          f"({full_words / sent_words:.0f}x smaller)", flush=True)

    # --- Server: expand + compute (still keyless). ----------------------
    alice_cts = server.expand_seeded((seed, body))
    out_nand = server.nand(bob_cts, alice_cts)
    out_xor = server.xor(bob_cts, alice_cts)

    # --- Alice: decrypt + verify. ---------------------------------------
    got_nand = alice.decrypt(out_nand).cpu().numpy()
    got_xor = alice.decrypt(out_xor).cpu().numpy()
    want_nand = 1 - (bob_bits & alice_bits)
    want_xor = bob_bits ^ alice_bits
    assert np.array_equal(got_nand, want_nand), (got_nand, want_nand)
    assert np.array_equal(got_xor, want_xor), (got_xor, want_xor)
    print(f"server computed NAND={got_nand.tolist()} XOR={got_xor.tolist()} "
          "— both decode correctly; server never saw a secret key", flush=True)


if __name__ == "__main__":
    main()
