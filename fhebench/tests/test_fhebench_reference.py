"""The reference at a tiny parameter size: its gates against the truth
tables, its lookups against the tables, and, word for word, against the
port on the same raw keys (the port is imported here only, never by the
reference)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fhebench.reference import tfhe as ref
from fhebench.reference import truth
from fhebench.tests.standin import TINY, TINY_PBS

ROWS = 24


def setup(cfg, seed=11):
    p = ref.Params.from_config(cfg)
    g = torch.Generator().manual_seed(seed)
    return p, g, ref.keygen(p, g, "cpu")


def port(p: ref.Params, keys: ref.Keys):
    from rustfhe_tpu_torch import keys as pkeys
    from rustfhe_tpu_torch.context import TFHE
    from rustfhe_tpu_torch.params import TFHEParams

    pp = TFHEParams(**{k: getattr(p, k) for k in ref.Params.__dataclass_fields__})
    words = [t.numpy().view(np.uint32) for t in (keys.s0, keys.s1, keys.bk, keys.ksk)]
    sk, ck = pkeys.from_jax_keys(*words, pp, "cpu", engine="cmux_k")
    return pp, TFHE(sk, ck, pp, "cpu", None, "cmux_k")


def test_params_of_the_ports_presets():
    from rustfhe_tpu_torch.params import DEFAULT_PARAMS, PBS_PARAMS, TEST_PARAMS

    for pp in (DEFAULT_PARAMS, PBS_PARAMS, TEST_PARAMS):
        p = ref.Params(**{k: getattr(pp, k) for k in ref.Params.__dataclass_fields__})
        assert (p.decomp_mask, p.iks_round, p.nbit, p.iks_t) == (
            pp.decomp_mask, pp.iks_round, pp.nbit, pp.iks_t)


@pytest.mark.parametrize("op", ["nand", "and", "or", "xor", "not", "mux"])
def test_gates_meet_truth_and_the_port(op):
    p, g, keys = setup(TINY)
    b = ref.bits(g, (3, ROWS), "cpu")
    cts = ref.encrypt(g, keys.s0, ref.bit_words(b), p.alpha_lv0)
    args = {"not": [cts[0]], "mux": [cts[0], cts[1], cts[2]]}.get(op, [cts[0], cts[1]])
    out = ref.gate(op, args, keys, p)
    want = truth.gate(op, *b.numpy())
    assert np.array_equal(ref.decrypt_bits(out, keys.s0).numpy(), want)
    _, ctx = port(p, keys)
    method = {"and": "and_", "or": "or_", "not": "not_"}.get(op, op)
    assert torch.equal(getattr(ctx, method)(*args), out)


@pytest.mark.parametrize("t", [1, 2])
def test_lookups_meet_tables_and_the_port(t):
    from rustfhe_tpu_torch import pbs

    p, g, keys = setup(TINY_PBS)
    x = torch.randint(0, 8, (ROWS,), generator=g)
    ct = ref.encrypt(g, keys.s0, ref.encode_int(x, 8), p.alpha_lv0)
    tables = torch.randint(0, 8, (ROWS, t, 8), generator=g)
    out = ref.pbs(ct, tables, 8, False, keys, p)
    for j in range(t):
        assert torch.equal(ref.decrypt_int(out[:, j], keys.s0, 8), tables[torch.arange(ROWS), j, x])
    pp, ctx = port(p, keys)
    if t == 1:
        got = pbs.pbs(ctx.ck, ct, tables[:, 0], space=8, params=pp, unsafe=True)[:, None]
    else:
        got = pbs.pbs_many(ctx.ck, ct, tables, space=8, params=pp, unsafe=True)
    assert torch.equal(got, out)


def test_raw_tables_and_lv1():
    """Raw torus words as table entries (the radix comparisons' +-mu), and
    the rotation stopped at the lv1 extraction."""
    from rustfhe_tpu_torch import bootstrap, pbs

    p, g, keys = setup(TINY_PBS, seed=12)
    x = torch.randint(0, 8, (ROWS,), generator=g)
    ct = ref.encrypt(g, keys.s0, ref.encode_int(x, 8), p.alpha_lv0)
    raw = torch.where(torch.arange(8) < 4, p.mu, (1 << 32) - p.mu).repeat(ROWS, 1)
    out = ref.pbs(ct, raw[:, None], 8, True, keys, p)[:, 0]
    assert np.array_equal(ref.decrypt_bits(out, keys.s0).numpy(), (x < 4).long().numpy())
    pp, ctx = port(p, keys)
    assert torch.equal(pbs.pbs(ctx.ck, ct, raw, space=8, params=pp, raw=True, unsafe=True), out)
    lv1 = ref.gate_bootstrap(ct, keys, p, switch=False)
    assert torch.equal(bootstrap.gate_bootstrapping_tlwe2tlwe(ct, ctx.ck.bk, pp), lv1)


def test_integer_truth():
    a, b = np.array([200, 7, 0, 255]), np.array([100, 9, 0, 1])
    c = np.array([1, 0, 1, 0])
    assert truth.uint_op("add", a, b, c, 8).tolist() == [44, 16, 0, 0]
    assert truth.uint_op("sub", a, b, c, 8).tolist() == [100, 254, 0, 254]
    assert truth.uint_op("lt", a, b, c, 8).tolist() == [0, 1, 0, 0]
    assert truth.uint_op("eq", a, b, c, 8).tolist() == [0, 0, 1, 0]
    assert truth.uint_op("min", a, b, c, 8).tolist() == [100, 7, 0, 1]
    assert truth.uint_op("select", a, b, c, 8).tolist() == [200, 9, 0, 1]
    assert truth.expr(("$", ("leaf", 1), ("not", ("^", ("leaf", 1), ("leaf", 0))))) == 1


def test_control_is_not_exact():
    """The float32 control leaves the words of a tiny rotation already."""
    p, g, keys = setup(TINY)
    b = ref.bits(g, (2, ROWS), "cpu")
    cts = ref.encrypt(g, keys.s0, ref.bit_words(b), p.alpha_lv0)
    exact = ref.gate("nand", [cts[0], cts[1]], keys, p)
    control = ref.gate("nand", [cts[0], cts[1]], keys, p, torch.float32)
    assert not torch.equal(exact, control)
