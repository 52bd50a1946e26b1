"""Wide table lookups as the benchmark's ``luts.pbs.b16k`` cell sends them,
at PBS_TEST_PARAMS on the CPU: ``pbs.pbs`` (t = 1) and ``pbs.pbs_many``
(t = 2) with a table per row, on keys that the benchmark's plain reference
(``fhebench/reference/tfhe.py``, torch alone) makes and that reach the port
through ``keys.from_jax_keys``, as ``fhebench.harness.port_context`` takes
them.  Every output word equals the reference's, and every output decrypts
to its row's table entry at the row's value.  The test set's margin at
space 8 is below the margin gate's, hence ``unsafe=True``.
"""

import numpy as np
import pytest
import torch

from fhebench.reference import tfhe as ref
from rustfhe_tpu_torch import keys, pbs
from rustfhe_tpu_torch.engine import select_engine
from rustfhe_tpu_torch.params import PBS_TEST_PARAMS as P

RP = ref.Params(**{k: getattr(P, k) for k in ref.Params.__dataclass_fields__})
ROWS, SPACE = 8, 8


@pytest.fixture(scope="module")
def lookups():
    gen = torch.Generator().manual_seed(2 ** 33 + 26)
    raw = ref.keygen(RP, gen, "cpu")
    words = [t.numpy().view(np.uint32) for t in (raw.s0, raw.s1, raw.bk, raw.ksk)]
    _, ck = keys.from_jax_keys(*words, P, "cpu", engine=select_engine(P, "cpu"))
    x = torch.randint(0, SPACE, (ROWS,), generator=gen)
    tables = torch.randint(0, SPACE, (ROWS, 2, SPACE), generator=gen)
    ct = ref.encrypt(gen, raw.s0, ref.encode_int(x, SPACE), RP.alpha_lv0)
    return raw, ck, x, tables, ct


@pytest.mark.parametrize("t", [1, 2])
def test_a_table_per_row_equals_the_reference_word_for_word(lookups, t):
    raw, ck, x, tables, ct = lookups
    tabs = tables[:, :t]
    if t == 1:
        got = pbs.pbs(ck, ct, tabs[:, 0], space=SPACE, params=P, unsafe=True)[:, None]
    else:
        got = pbs.pbs_many(ck, ct, tabs, space=SPACE, params=P, unsafe=True)
    want = ref.pbs(ct, tabs, SPACE, False, raw, RP)
    assert got.shape == (ROWS, t, P.n + 1) and torch.equal(got, want)
    entries = tabs[torch.arange(ROWS), :, x]  # (ROWS, t): each row's tables at its value
    assert torch.equal(ref.decrypt_int(got, raw.s0, SPACE), entries)
