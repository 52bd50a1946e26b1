"""The CUDA kernels K1-K6 (and K4/K6's pieces, and K1's Karatsuba step) and
the probes P1-P10 against their plain versions, and the generic engines "matmul" and "matmul_bf16" against
their CPU products, on the card; the integer, PBS and radix paths on K1
and K3 (a test vector per row at PBS_PARAMS) against the CPU and the K1 loop;
the seeded expansion (threefry) on the card against the CPU's; the one-hot
key switch on P9 and the grouped (k=2) NAND of the studies.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so it also runs on a GPU host that has no jax, with the
JAX-side conftest left out:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Inputs come from numpy seeds; comparisons are exact (words mod 2^32).
"""

import threading

import numpy as np
import pytest
import torch

from rustfhe_tpu_torch import TFHE, _u32, engine, params
from rustfhe_tpu_torch.engine import (cmux_k, int8_gemm, karatsuba, karatsuba_probe, limb_probe,
                                      limb_step, nuss_primitives, oracle, plain, rotate_all_k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, B, p):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    ai = rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)
    ai[:4] = [0, 1, p.N, 2 * p.N - 1][:B]
    digits = rs.randint(-128, 128, size=(B, 2 * p.l, p.N)).astype(np.int8)
    return rows, acc, ai, digits


# K1 and K2 at every shape class: N=64 (one padded 128-byte slice, KT = 6 not
# a multiple of the ring's 4 stages), DEFAULT, FAST (l=2, Bg=2^8), N=2048
# at l=3 and l=4 (PBS_PARAMS, past the old kernel's shared memory).
CMUX_PARAMS = {"TEST_PARAMS": params.TEST_PARAMS, "DEFAULT_PARAMS": params.DEFAULT_PARAMS,
               "FAST_PARAMS": params.FAST_PARAMS, "N2048_PARAMS": params.N2048_PARAMS,
               "PBS_PARAMS": params.PBS_PARAMS}


def _more_tiles_than_blocks(cuda) -> int:
    """A batch whose product at TEST_PARAMS (2 tiles per 128 samples) has
    more tiles than the persistent grid has blocks (one per SM), so that a
    block's next tile starts mid-round in the ring (KT = 6)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return 128 * (sms // 2 + 2)


@pytest.mark.parametrize("B", [1, 13, 129])  # one sample; a ragged tile; two tiles
@pytest.mark.parametrize("name", list(CMUX_PARAMS))
def test_cmux_step_kernel_matches_plain(cuda, name, B):
    p = CMUX_PARAMS[name]
    rows, acc, ai, _ = _case(37, B, p)
    rows[0, 0, :2] = [0x80808080, 0xFFFFFFFF]
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    want = cmux_k.cmux_step(_u32.from_numpy(acc), torch.from_numpy(ai), key, p)
    before = cmux_k.cmux_step.launches
    got = cmux_k.cmux_step(_u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda),
                           key.to(cuda), p)
    assert cmux_k.cmux_step.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B", [1, 13, 129])
@pytest.mark.parametrize("name", list(CMUX_PARAMS))
def test_external_product_kernel_matches_plain_and_oracle(cuda, name, B):
    p = CMUX_PARAMS[name]
    rows, _, _, digits = _case(38, B, p)
    digits[0, 0, :2] = [-128, 127]
    t_rows = _u32.from_numpy(rows)
    key = plain.prepare_trgsw(t_rows)
    d8 = torch.from_numpy(digits)
    want = cmux_k.external_product(d8, key, p)
    got = cmux_k.external_product(d8.to(cuda), key.to(cuda), p)
    assert torch.equal(got.cpu(), want)
    # the probe vectors against the oracle, as the engine's admission runs them
    rows_np, digits_np = engine.probe_vectors(p)
    pd = torch.from_numpy(digits_np)
    got = cmux_k.external_product(pd.to(torch.int8).to(cuda),
                                  plain.prepare_trgsw(_u32.from_numpy(rows_np, cuda)), p)
    assert torch.equal(got.cpu(), oracle.external_product(_u32.from_numpy(rows_np), pd))


def test_cmux_kernels_with_more_tiles_than_blocks(cuda):
    p = params.TEST_PARAMS
    B = _more_tiles_than_blocks(cuda)
    rows, acc, ai, digits = _case(39, B, p)
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    want = cmux_k.cmux_step(_u32.from_numpy(acc), torch.from_numpy(ai), key, p)
    got = cmux_k.cmux_step(_u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda),
                           key.to(cuda), p)
    assert torch.equal(got.cpu(), want)
    d8 = torch.from_numpy(digits)
    got = cmux_k.external_product(d8.to(cuda), key.to(cuda), p)
    assert torch.equal(got.cpu(), cmux_k.external_product(d8, key, p))


def test_cmux_step_threads_keep_their_own_buffers(cuda):
    # two threads stepping at the same batch on the default stream, side by
    # side: each uses its own digit and panel buffers, so neither step reads
    # the other's digits or panels
    p, B, steps = params.DEFAULT_PARAMS, 256, 16
    inputs, want = [], []
    for seed in (41, 42):
        rows, acc, ai, _ = _case(seed, B, p)
        case = (_u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda),
                plain.prepare_trgsw(_u32.from_numpy(rows, cuda)))
        a = case[0]
        for _ in range(steps):
            a = cmux_k.cmux_step_plain(a, case[1], case[2], p)
        inputs.append(case)
        want.append(a.cpu())
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def run(t):
        try:
            a, ai, key = inputs[t]
            start.wait()
            for _ in range(steps):
                a = cmux_k.cmux_step(a, ai, key, p)
            got[t] = a.cpu()
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for t in range(2):
        assert torch.equal(got[t], want[t])


def _fresh_thread_calls(cuda):
    """Calls that plan a product (TMA maps) before they launch anything, no
    torch kernel before them: a single step on either product, a whole
    rotation, the int8 GEMM; (name, call, plain version)."""
    p = params.DEFAULT_PARAMS.replace(n=3)
    rows, acc, ai, _ = _case(43, 33, p)
    acc, ai = _u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda)
    key = plain.prepare_trgsw(_u32.from_numpy(rows, cuda))
    table = cmux_k.leaf_table(key[None], p)[0]
    a3 = torch.stack([ai, ai.flip(0), ai]).contiguous()
    keys = key[None].expand(3, -1, -1, -1).contiguous()
    first = acc.clone()  # the rotation's, which it overwrites
    d = torch.from_numpy(np.random.RandomState(44).randint(-128, 128, size=(128, 256))
                         .astype(np.int8)).to(cuda)
    w = torch.from_numpy(np.random.RandomState(45).randint(-128, 128, size=(256, 256))
                         .astype(np.int8)).to(cuda)
    wt = int8_gemm.prepare_rhs(w)

    def chain():
        out = acc
        for i in range(3):
            out = cmux_k.cmux_step_plain(out, a3[i], key, p)
        return out

    return [
        ("cmux_step", lambda: cmux_k.cmux_step(acc, ai, key, p),
         lambda: cmux_k.cmux_step_plain(acc, ai, key, p)),
        ("cmux_step_karatsuba", lambda: cmux_k.cmux_step_karatsuba(acc, ai, table, p),
         lambda: cmux_k.cmux_step_plain(acc, ai, key, p)),
        ("rotate", lambda: cmux_k.rotate(first, a3, keys, p, "schoolbook"), chain),
        ("int8_matmul", lambda: int8_gemm.int8_matmul(d, wt),
         lambda: int8_gemm.int8_matmul_plain(d.cpu(), w.cpu()).to(cuda)),
    ]


def test_a_fresh_threads_first_call_plans_and_launches(cuda):
    """A thread whose first call into a library plans a product (TMA maps)
    before any launch of that library: a single K1 step on either product,
    a rotation, the int8 GEMM, each alone in a new thread, = its plain
    version."""
    for name, call, want in _fresh_thread_calls(cuda):
        got, errors = [], []

        def run():
            try:
                got.append(call())
            except Exception as e:  # re-raised in the test's thread
                errors.append(e)

        th = threading.Thread(target=run)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive() and not errors, (name, errors)
        assert torch.equal(got[0], want()), name


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS"])
def test_cmux_step_pieces_match_plain(cuda, name):
    # the panel, digit and product kernels alone, each against its plain version
    p = CMUX_PARAMS[name]
    rows, acc, ai, _ = _case(40, 13, p)
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    panel = cmux_k.key_panel(key.to(cuda), p)
    assert torch.equal(panel.cpu(), cmux_k.key_panel_plain(key, p))
    digits = cmux_k.step_digits(t_acc.to(cuda), t_ai.to(cuda), p)
    assert torch.equal(digits.cpu(), cmux_k.step_digits_plain(t_acc, t_ai, p))
    got = cmux_k.panel_product(digits, panel, t_acc.to(cuda), p)
    assert torch.equal(got.cpu(), cmux_k.panel_product_plain(digits.cpu(), panel.cpu(), t_acc, p))


def test_cmux_kernels_refuse_what_they_do_not_take(cuda):
    for N in (4, 4096):
        p = params.TEST_PARAMS.replace(N=N)
        acc = torch.zeros((1, 2, N), dtype=torch.int32, device=cuda)
        key = torch.zeros((2 * p.l, 2, 2 * N), dtype=torch.int32, device=cuda)
        before = cmux_k.cmux_step.launches
        with pytest.raises(ValueError, match="power of two"):
            cmux_k.cmux_step(acc, torch.zeros((1,), dtype=torch.int32, device=cuda), key, p)
        assert cmux_k.cmux_step.launches == before


def test_selector_and_gates_on_card(cuda):
    p = params.TEST_PARAMS
    assert engine.select_engine(p, cuda, "cmux_k") == "cmux_k"
    ctx = TFHE.new(5, p, device=cuda, engine_name="cmux_k")
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    before = cmux_k.cmux_step.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert cmux_k.cmux_step.launches == before + p.n


@pytest.mark.parametrize("N,B", [(64, 1), (64, 9), (1024, 3)])
def test_rotate_all_kernel_matches_plain(cuda, N, B):
    p = params.TFHEParams(n=13, N=N)
    rs = np.random.RandomState(40 + B)
    rows = rs.randint(0, 2**32, size=(p.n, 2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    a = rs.randint(0, 2 * p.N, size=(p.n, B)).astype(np.int32)
    a[:4, 0] = [0, p.N, 2 * p.N - 1, 1]
    bk = plain.prepare_trgsw(_u32.from_numpy(rows))
    t_acc, t_a = _u32.from_numpy(acc), torch.from_numpy(a)
    want = rotate_all_k.rotate_all(t_acc, t_a, bk, p)
    assert torch.equal(want, rotate_all_k.rotate_all_plain(t_acc, t_a, bk, p))
    before = rotate_all_k.rotate_all.launches
    got = rotate_all_k.rotate_all(t_acc.to(cuda), t_a.to(cuda), bk.to(cuda), p)
    assert rotate_all_k.rotate_all.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_latency_mode_gates_on_card(cuda):
    p = params.TEST_PARAMS
    ctx = TFHE.new(6, p, device=cuda, latency_mode=True, engine_name="cmux_k")
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    k1, k3 = cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert cmux_k.cmux_step.launches == k1
    assert rotate_all_k.rotate_all.launches == k3 + 1


def test_latency_mode_takes_the_k1_loop_where_k3_does_not_take_the_shape(cuda):
    # Bg = 2^8 (FAST_PARAMS' base) on the "cmux_k" engine: K1 per step, no K3
    p = params.TEST_PARAMS.replace(bgbit=8, l=2)
    ctx = TFHE.new(6, p, device=cuda, latency_mode=True, engine_name="cmux_k")
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    k1, k3 = cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert cmux_k.cmux_step.launches == k1 + p.n
    assert rotate_all_k.rotate_all.launches == k3


# K3 (one cluster per sample, the step on the tensor cores) at TEST_PARAMS
# (N=64: a cluster of one block), DEFAULT and N=2048 (l=3, and l=4 at
# PBS_PARAMS), a shortened rotation of n steps.
ROTATE_PARAMS = {"TEST_PARAMS": params.TEST_PARAMS, "DEFAULT_PARAMS": params.DEFAULT_PARAMS,
                 "N2048_PARAMS": params.N2048_PARAMS, "PBS_PARAMS": params.PBS_PARAMS}


def _rotation_case(seed, B, p, cuda):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(p.n, 2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    rows[0, 0, 0, :2] = [0x80808080, 0xFFFFFFFF]
    acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    a = rs.randint(0, 2 * p.N, size=(p.n, B)).astype(np.int32)
    a[:4, 0] = [0, p.N, 2 * p.N - 1, 1]
    return (_u32.from_numpy(acc, cuda), torch.from_numpy(a).to(cuda),
            plain.prepare_trgsw(_u32.from_numpy(rows, cuda)))


def _k1_loop(acc, a, bk, p):
    for i in range(p.n):
        acc = cmux_k.cmux_step(acc, a[i], bk[i], p)
    return acc


@pytest.mark.parametrize("B", sorted({1, 2, 13, 16, 33, rotate_all_k.MAX_BATCH}))
@pytest.mark.parametrize("name", list(ROTATE_PARAMS))
def test_rotate_all_kernel_matches_plain_and_the_k1_loop(cuda, name, B):
    p = ROTATE_PARAMS[name].replace(n=24)
    acc, a, bk = _rotation_case(60 + B, B, p, cuda)
    want = rotate_all_k.rotate_all_plain(acc, a, bk, p)
    before = rotate_all_k.rotate_all.launches
    got = rotate_all_k.rotate_all(acc, a, bk, p)
    assert rotate_all_k.rotate_all.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, _k1_loop(acc, a, bk, p))


def _full_rotation_case(seed, B, p, cuda, per_row):
    """A whole rotation's inputs at ``p``'s n: the first accumulator and the
    rotations from random lv0 words and test vectors (one for every row, or
    one per row) through ``bootstrap.rotation_start``, and a random key."""
    from rustfhe_tpu_torch import bootstrap

    rs = np.random.RandomState(seed)

    def words(*shape):
        return _u32.from_numpy(np.frombuffer(rs.bytes(4 * int(np.prod(shape))),
                                             dtype=np.uint32).reshape(shape), cuda)

    tv = words(B, 2, p.N) if per_row else words(2, p.N)
    acc, a = bootstrap.rotation_start(words(B, p.n + 1), tv, p)
    return acc, a, plain.prepare_trgsw(words(p.n, 2 * p.l, 2, p.N))


@pytest.mark.parametrize("B", [1, 33, 300, 4096])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_cmux_rotate_equals_the_cmux_step_chain(cuda, name, B):
    """A rotation from one call (n = 635 at DEFAULT_PARAMS, 714 at
    PBS_PARAMS with a test vector per row: both parities of the ping-pong)
    = n calls of cmux_step, word for word; it counts n steps and one
    rotation."""
    p = CMUX_PARAMS[name]
    acc, a, bk = _full_rotation_case(80 + B, B, p, cuda, per_row=name == "PBS_PARAMS")
    want = _k1_loop(acc, a, bk, p)
    k1, rot = cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches
    got = cmux_k.cmux_rotate(acc.clone(), a, bk, p)
    assert (cmux_k.cmux_step.launches - k1, cmux_k.cmux_rotate.launches - rot) == (p.n, 1)
    assert torch.equal(got, want)


def test_cmux_rotate_on_a_side_stream(cuda):
    p = params.DEFAULT_PARAMS
    acc, a, bk = _full_rotation_case(79, 300, p, cuda, per_row=False)
    want = _k1_loop(acc, a, bk, p)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))  # the inputs were made on the default one
    with torch.cuda.stream(side):
        got = cmux_k.cmux_rotate(acc.clone(), a, bk, p)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(got, want)


# K1 on the Karatsuba product: DEFAULT_PARAMS at B = 1,024, 4,096, 16,384 and an odd B, PBS_PARAMS
# with a test vector per row at B = 512 and 4,096.
KARATSUBA_CASES = [("DEFAULT_PARAMS", B) for B in (1024, 4096, 4099, 16384)] + [
    ("PBS_PARAMS", B) for B in (512, 4096)]


@pytest.mark.parametrize("name,B", KARATSUBA_CASES)
def test_karatsuba_step_matches_the_schoolbook_step(cuda, name, B):
    """One Karatsuba step on the card = K1's schoolbook step on the card = the
    plain step (``step_digits_plain``, then the float64 external product;
    on the card in plain torch), word for word, from a random accumulator
    and key."""
    p = CMUX_PARAMS[name]
    rs = np.random.RandomState(90 + B)

    def words(*shape):
        return _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64), cuda)

    acc = words(B, 2, p.N)
    a = torch.from_numpy(rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)).to(cuda)
    key = plain.prepare_trgsw(words(1, 2 * p.l, 2, p.N))
    table = cmux_k.leaf_table(key, p)[0]
    before = (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches)
    got = cmux_k.cmux_step_karatsuba(acc, a, table, p)
    assert (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, cmux_k.cmux_step(acc, a, key[0], p))
    digits = cmux_k.step_digits_plain(acc, a, p)[..., :p.N].contiguous()
    assert torch.equal(got, acc + plain.external_product(digits, key[0]))


@pytest.mark.parametrize("name,B", KARATSUBA_CASES)
def test_cmux_rotate_on_the_karatsuba_step_equals_the_schoolbook_chain(cuda, name, B):
    """A whole rotation from one call on the Karatsuba steps (n = 635 or 714)
    = n calls of K1's schoolbook cmux_step, word for word; it counts n steps,
    n Karatsuba steps and one rotation."""
    p = CMUX_PARAMS[name]
    assert cmux_k.product_for(p, B) == "karatsuba"
    acc, a, bk = _full_rotation_case(60 + B, B, p, cuda, per_row=name == "PBS_PARAMS")
    want = _k1_loop(acc, a, bk, p)
    before = (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches,
              cmux_k.cmux_rotate.launches)
    got = cmux_k.cmux_rotate(acc.clone(), a, bk, p)
    assert (cmux_k.cmux_step.launches - before[0], cmux_k.cmux_step_karatsuba.launches - before[1],
            cmux_k.cmux_rotate.launches - before[2]) == (p.n, p.n, 1)
    assert torch.equal(got, want)


def test_cmux_rotate_on_the_karatsuba_step_on_a_side_stream(cuda):
    p = params.DEFAULT_PARAMS
    acc, a, bk = _full_rotation_case(78, 1024, p, cuda, per_row=False)
    want = _k1_loop(acc, a, bk, p)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))  # the inputs were made on the default one
    with torch.cuda.stream(side):
        before = cmux_k.cmux_step_karatsuba.launches
        got = cmux_k.cmux_rotate(acc.clone(), a, bk, p)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert cmux_k.cmux_step_karatsuba.launches == before + p.n
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_cmux_rotate_takes_the_karatsuba_step_from_its_threshold(cuda, name):
    """One row below the measured threshold the rotation takes the schoolbook
    step, at it the Karatsuba step; both = the per-step chain."""
    p = CMUX_PARAMS[name]
    least = cmux_k.KARATSUBA_MIN_ROWS[(p.N, p.l, p.bgbit)]
    for B, steps in ((least - 1, 0), (least, p.n)):
        acc, a, bk = _full_rotation_case(50 + B, B, p, cuda, per_row=name == "PBS_PARAMS")
        want = _k1_loop(acc, a, bk, p)
        before = cmux_k.cmux_step_karatsuba.launches
        got = cmux_k.cmux_rotate(acc.clone(), a, bk, p)
        assert cmux_k.cmux_step_karatsuba.launches - before == steps
        assert torch.equal(got, want)


# One step on either product, each side of the Karatsuba threshold's batches.
SINGLE_STEPS = [("schoolbook", "DEFAULT_PARAMS", 13), ("schoolbook", "PBS_PARAMS", 4096),
                ("karatsuba", "DEFAULT_PARAMS", 1024), ("karatsuba", "PBS_PARAMS", 512)]


@pytest.mark.parametrize("product,name,B", SINGLE_STEPS)
def test_one_step_is_a_rotation_of_one(cuda, product, name, B):
    """``cmux_step`` and ``cmux_step_karatsuba`` run their product's rotation
    entry at n = 1: the plain step word for word (in torch on the card),
    one step counted and no rotation, ``acc`` not written."""
    p = CMUX_PARAMS[name]
    rs = np.random.RandomState(110 + B)

    def words(*shape):
        return _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64), cuda)

    acc = words(B, 2, p.N)
    a = torch.from_numpy(rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)).to(cuda)
    key = plain.prepare_trgsw(words(1, 2 * p.l, 2, p.N))
    first = acc.clone()
    want = cmux_k.cmux_step_plain(acc, a, key[0], p)
    before = (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches,
              cmux_k.cmux_rotate.launches)
    if product == "schoolbook":
        got = cmux_k.cmux_step(acc, a, key[0], p)
    else:
        got = cmux_k.cmux_step_karatsuba(acc, a, cmux_k.leaf_table(key, p)[0], p)
    assert (cmux_k.cmux_step.launches - before[0], cmux_k.cmux_step_karatsuba.launches - before[1],
            cmux_k.cmux_rotate.launches - before[2]) == (1, int(product == "karatsuba"), 0)
    assert torch.equal(got, want)
    assert torch.equal(acc, first)


def _karatsuba_case(seed, B, p, steps, cuda):
    """A Karatsuba rotation's inputs: a random accumulator, ``steps`` rows of
    rotations whose first samples take a~ = 0, 1, N, 2N - 2 and 2N - 1, a
    random prepared key and its leaf tables."""
    rs = np.random.RandomState(seed)

    def words(*shape):
        return _u32.from_numpy(np.frombuffer(rs.bytes(4 * int(np.prod(shape))),
                                             dtype=np.uint32).reshape(shape), cuda)

    a = rs.randint(0, 2 * p.N, size=(steps, B)).astype(np.int32)
    edge = [0, 1, p.N, 2 * p.N - 2, 2 * p.N - 1]
    a[:, :min(B, len(edge))] = edge[:B]
    key = plain.prepare_trgsw(words(steps, 2 * p.l, 2, p.N))
    return words(B, 2, p.N), torch.from_numpy(a).to(cuda), key, cmux_k.leaf_table(key, p)


def _karatsuba_rows(rows, p):
    """The batch a card test names: the measured threshold, a count past it
    that is no multiple of 128 (a ragged tile of samples), or a number."""
    least = cmux_k.KARATSUBA_MIN_ROWS[(p.N, p.l, p.bgbit)]
    return {"threshold": least, "ragged": least + 77}.get(rows, rows)


@pytest.mark.parametrize("rows", ["threshold", "ragged", 4096])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_karatsuba_step_and_rotation_at_the_threshold_and_edge_rotations(cuda, name, rows):
    """The four-launch Karatsuba step (leaf panels, tree digits, the nine
    leaf GEMMs, the combine) = ``cmux_step_plain`` word for word: a single
    ``cmux_step_karatsuba`` and a 3-step rotation on the Karatsuba product,
    with a~ = 0 and a~ near 2N among the rows; then the step's leaf products,
    read back from its buffer, = their plain version from its tree digits
    and leaf panels."""
    p = CMUX_PARAMS[name]
    B = _karatsuba_rows(rows, p)
    acc, a, key, tables = _karatsuba_case(120 + B, B, p, 3, cuda)
    want = acc
    for i in range(3):
        want = cmux_k.cmux_step_plain(want, a[i], key[i], p)
        if i == 0:
            got = cmux_k.cmux_step_karatsuba(acc, a[0], tables[0], p)
            assert torch.equal(got, want)
            digits, panel, leaves = cmux_k.step_buffers(
                "karatsuba", B, p, acc.device, torch.cuda.current_stream(cuda).cuda_stream)
            assert torch.equal(leaves, karatsuba_probe.leaves_plain(digits, panel, tables[0], p))
    before = cmux_k.cmux_step_karatsuba.launches
    assert torch.equal(cmux_k.rotate(acc.clone(), a, tables, p, "karatsuba"), want)
    assert cmux_k.cmux_step_karatsuba.launches == before + 3


@pytest.mark.parametrize("B", [1, 13, 4096])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_leaf_combine_matches_the_plain_tree_combine(cuda, name, B):
    """The Karatsuba step's combine launch alone = the plain tree combine
    (``karatsuba.combine_leaves`` on the CPU) from random words, where every
    position 0 takes its Z terms from position ns - 1, negated; and one word
    at the last position of leaf 1 lands at position 0 (-x, +x in residues
    0, 1) and at the last position (-x, +x in residues 2, 3)."""
    p = CMUX_PARAMS[name]
    ns = p.N // karatsuba.R
    rs = np.random.RandomState(140 + B)
    acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    leaves = rs.randint(0, 2**32, size=(B, karatsuba.T, 2, ns), dtype=np.uint64).astype(np.uint32)
    want = karatsuba.combine_leaves(_u32.from_numpy(acc), _u32.from_numpy(leaves))
    got = cmux_k.leaf_combine(_u32.from_numpy(acc, cuda), _u32.from_numpy(leaves, cuda), p)
    assert torch.equal(got.cpu(), want)
    one = torch.zeros((B, karatsuba.T, 2, ns), dtype=torch.int32, device=cuda)
    one[-1, 1, 1, ns - 1] = x = 0x9E3779B9 - 2**32
    got = cmux_k.leaf_combine(torch.zeros((B, 2, p.N), dtype=torch.int32, device=cuda), one, p)
    want = torch.zeros((B, 2, p.N), dtype=torch.int64)
    want[-1, 1, [0, 1, p.N - 2, p.N - 1]] = torch.tensor([-x, x, -x, x])
    assert torch.equal(got.cpu(), _u32.wrap(want))


@pytest.mark.parametrize("B", [4096, 4099])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_karatsuba_rotation_of_24_steps_equals_the_schoolbook_rotation(cuda, name, B):
    """24 steps from one call on each product (``benches/karatsuba_crossover.py``'s
    rotation) give the same words."""
    p = CMUX_PARAMS[name].replace(n=24)
    acc, a, key, tables = _karatsuba_case(160 + B, B, p, p.n, cuda)
    assert torch.equal(cmux_k.rotate(acc.clone(), a, tables, p, "karatsuba"),
                       cmux_k.rotate(acc.clone(), a, key, p, "schoolbook"))


@pytest.mark.parametrize("B", [13, 300])
@pytest.mark.parametrize("N", [32, 64, 128])
def test_karatsuba_step_at_small_ring_degrees(cuda, N, B):
    """Leaves of 8-32 positions, narrower than one panel box of the leaf
    product's tile: a Karatsuba step = ``cmux_step_plain``."""
    p = params.DEFAULT_PARAMS.replace(N=N)
    acc, a, key, tables = _karatsuba_case(180 + N + B, B, p, 1, cuda)
    assert torch.equal(cmux_k.cmux_step_karatsuba(acc, a[0], tables[0], p),
                       cmux_k.cmux_step_plain(acc, a[0], key[0], p))


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "N2048_PARAMS"])
def test_rotate_all_kernel_at_both_cluster_sizes(cuda, name, cluster):
    p = ROTATE_PARAMS[name].replace(n=16)
    acc, a, bk = _rotation_case(70, 3, p, cuda)
    got = rotate_all_k._rotate_all(acc, a, bk, p, cluster)
    assert torch.equal(got, rotate_all_k.rotate_all_plain(acc, a, bk, p))
    assert rotate_all_k.max_clusters(p, cluster) >= 1


def test_rotate_all_kernel_full_rotation_at_default(cuda):
    p = params.DEFAULT_PARAMS
    acc, a, bk = _rotation_case(71, 1, p, cuda)
    assert torch.equal(rotate_all_k.rotate_all(acc, a, bk, p), _k1_loop(acc, a, bk, p))


def test_rotate_all_kernel_threads_side_by_side(cuda):
    # two threads rotating different samples at once, each on its own stream
    p = params.DEFAULT_PARAMS.replace(n=32)
    cases = [_rotation_case(seed, 2, p, cuda) for seed in (72, 73)]
    want = [rotate_all_k.rotate_all_plain(*c, p) for c in cases]
    torch.cuda.synchronize()  # the side streams read inputs made on the default one
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def run(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                start.wait()
                for _ in range(3):
                    out = rotate_all_k.rotate_all(*cases[t], p)
                torch.cuda.current_stream().synchronize()
            got[t] = out
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for t in range(2):
        assert torch.equal(got[t], want[t])


def test_rotate_all_kernel_refuses_what_it_does_not_take(cuda):
    for p in (params.TEST_PARAMS.replace(N=32, n=2), params.FAST_PARAMS.replace(n=2)):
        acc = torch.zeros((1, 2, p.N), dtype=torch.int32, device=cuda)
        a = torch.zeros((p.n, 1), dtype=torch.int32, device=cuda)
        bk = torch.zeros((p.n, 2 * p.l, 2, 2 * p.N), dtype=torch.int32, device=cuda)
        before = rotate_all_k.rotate_all.launches
        with pytest.raises(ValueError):
            rotate_all_k.rotate_all(acc, a, bk, p)
        assert rotate_all_k.rotate_all.launches == before


@pytest.mark.parametrize("name", ["FAST_PARAMS", "DEFAULT_PARAMS"])
def test_limb_kernels_match_plain(cuda, name):
    p = getattr(params, name)
    rows, acc, ai, digits = _case(41, 13, p)  # 13 samples: a ragged last tile
    t_rows = _u32.from_numpy(rows)
    table = plain.prepare_trgsw_limbs(t_rows)
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    want = limb_step.cmux_step_plain(t_acc, t_ai, table, p)
    for step in (limb_step.cmux_step_merged, limb_step.cmux_step_split):  # K4, K6
        before = step.launches
        got = step(t_acc.to(cuda), t_ai.to(cuda), table.to(cuda), p)
        assert step.launches == before + 1
        assert torch.equal(got.cpu(), want)
    d8 = torch.from_numpy(digits)
    before = limb_step.external_product.launches
    got = limb_step.external_product(d8.to(cuda), table.to(cuda), p)  # K5
    assert limb_step.external_product.launches == before + 1
    assert torch.equal(got.cpu(), limb_step.external_product_plain(d8, table))
    assert torch.equal(got.cpu(), oracle.external_product(t_rows, d8))


def test_limb_engine_selected_and_gates_on_card(cuda):
    assert engine.select_engine(params.FAST_PARAMS, cuda) == "limb"
    p = params.FAST_PARAMS.replace(n=16)
    ctx = TFHE.new(7, p, device=cuda)
    assert ctx.engine_name == "limb"
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    k4, k1 = limb_step.cmux_step_merged.launches, cmux_k.cmux_step.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert limb_step.cmux_step_merged.launches == k4 + p.n
    assert cmux_k.cmux_step.launches == k1


# K4 and K6 (the K1 GEMM on the limb table) at every shape class: TEST_PARAMS
# (N=64 padded to one slice, KT = 6: the ring wraps mid-tile), FAST, DEFAULT
# and PBS_PARAMS (N=2048, l=4: past K5's shared memory).
LIMB_PARAMS = {"TEST_PARAMS": params.TEST_PARAMS, "FAST_PARAMS": params.FAST_PARAMS,
               "DEFAULT_PARAMS": params.DEFAULT_PARAMS, "PBS_PARAMS": params.PBS_PARAMS}
LIMB_STEPS = {"K4": limb_step.cmux_step_merged, "K6": limb_step.cmux_step_split}


def _limb_case(seed, B, p, cuda):
    """rows with the limb edges, acc, a~ on the card, and the step's limb table."""
    rows, acc, ai, _ = _case(seed, B, p)
    rows[0, 0, :2] = [0x80808080, 0xFFFFFFFF]
    table = plain.prepare_trgsw_limbs(_u32.from_numpy(rows, cuda))
    return rows, _u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda), table


@pytest.mark.parametrize("B", [1, 13, 129])  # one sample; a ragged tile; two tiles
@pytest.mark.parametrize("name", list(LIMB_PARAMS))
def test_limb_step_kernels_match_plain(cuda, name, B):
    p = LIMB_PARAMS[name]
    _, acc, ai, table = _limb_case(51, B, p, cuda)
    want = limb_step.cmux_step_plain(acc, ai, table, p)  # float64 on the card
    for tag, step in LIMB_STEPS.items():
        before = step.launches
        got = step(acc, ai, table, p)
        assert step.launches == before + 1, tag
        assert torch.equal(got, want), tag


@pytest.mark.parametrize("N", [8, 16, 32, 64, 128, 256, 512, 1024, 2048])
def test_limb_step_kernels_at_every_ring_degree(cuda, N):
    # N < 32 leaves most of K4's 32-coefficient tile past N, N < 128 pads
    # the digits to one slice, N = 2048 has 16 slices a plane
    p = params.FAST_PARAMS.replace(N=N)
    _, acc, ai, table = _limb_case(52, 13, p, cuda)
    want = limb_step.cmux_step_plain(acc, ai, table, p)
    for tag, step in LIMB_STEPS.items():
        assert torch.equal(step(acc, ai, table, p), want), (tag, N)


@pytest.mark.parametrize("name", ["TEST_PARAMS", "FAST_PARAMS", "DEFAULT_PARAMS", "PBS_PARAMS"])
def test_limb_step_pieces_match_plain(cuda, name):
    # the limb panel (= K1's key panel), and the product in K4's merged tile
    # and in K6's (K1's) tile, each against its plain version
    p = LIMB_PARAMS[name]
    rows, acc, ai, table = _limb_case(53, 13, p, cuda)
    panel = limb_step.limb_panel(table, p)
    assert torch.equal(panel, limb_step.limb_panel_plain(table, p))
    assert torch.equal(panel, cmux_k.key_panel(plain.prepare_trgsw(_u32.from_numpy(rows, cuda)), p))
    digits = cmux_k.step_digits(acc, ai, p)
    want = limb_step.cmux_step_plain(acc, ai, table, p)
    got = limb_step.merged_product(digits, panel, acc, p)
    assert torch.equal(got, limb_step.merged_product_plain(digits, panel, acc, p))
    assert torch.equal(got, want)
    got = cmux_k.panel_product(digits, panel, acc, p)
    assert torch.equal(got, cmux_k.panel_product_plain(digits, panel, acc, p))
    assert torch.equal(got, want)


def test_limb_step_kernels_with_more_tiles_than_blocks(cuda):
    p = params.TEST_PARAMS
    _, acc, ai, table = _limb_case(54, _more_tiles_than_blocks(cuda), p, cuda)
    want = limb_step.cmux_step_plain(acc, ai, table, p)
    for tag, step in LIMB_STEPS.items():
        assert torch.equal(step(acc, ai, table, p), want), tag


def test_limb_steps_threads_keep_their_own_buffers(cuda):
    # two threads stepping side by side, one on K4 and one on K6, each on
    # its own digit and panel buffers
    p, B, steps = params.FAST_PARAMS, 256, 16
    inputs, want = [], []
    for seed in (55, 56):
        _, acc, ai, table = _limb_case(seed, B, p, cuda)
        a = acc
        for _ in range(steps):
            a = limb_step.cmux_step_plain(a, ai, table, p)
        inputs.append((acc, ai, table))
        want.append(a)
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def run(t):
        try:
            a, ai, table = inputs[t]
            step = (limb_step.cmux_step_merged, limb_step.cmux_step_split)[t]
            start.wait()
            for _ in range(steps):
                a = step(a, ai, table, p)
            got[t] = a.clone()
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for t in range(2):
        assert torch.equal(got[t], want[t])


def test_limb_steps_run_pbs_params_bit_exact(cuda):
    # N=2048, l=4 (K4 needed 384 KB of shared memory in its __dp4a form):
    # K4 and K6 equal the plain step and K1 on the same key
    p = params.PBS_PARAMS
    rows, acc, ai, table = _limb_case(57, 300, p, cuda)
    k1 = cmux_k.cmux_step(acc, ai, plain.prepare_trgsw(_u32.from_numpy(rows, cuda)), p)
    assert torch.equal(k1, limb_step.cmux_step_plain(acc, ai, table, p))
    for tag, step in LIMB_STEPS.items():
        assert torch.equal(step(acc, ai, table, p), k1), tag


# K5 (the limb panel and the product without the add, on the caller's
# digits) at every shape class K4/K6 take, PBS_PARAMS included.
EXTPROD_BATCHES = [1, 4, 13, 129, 4096]


@pytest.mark.parametrize("B", EXTPROD_BATCHES)
@pytest.mark.parametrize("name", list(LIMB_PARAMS))
def test_limb_external_product_matches_plain_and_k2(cuda, name, B):
    p = LIMB_PARAMS[name]
    rows, _, _, digits = _case(58, B, p)
    rows[0, 0, :2] = [0x80808080, 0xFFFFFFFF]
    digits[0, 0, :2] = [-128, 127]
    t_rows = _u32.from_numpy(rows, cuda)
    table = plain.prepare_trgsw_limbs(t_rows)
    d8 = torch.from_numpy(digits).to(cuda)
    want = limb_step.external_product_plain(d8, table)  # float64 on the card
    before = limb_step.external_product.launches
    got = limb_step.external_product(d8, table, p)
    assert limb_step.external_product.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, cmux_k.external_product(d8, plain.prepare_trgsw(t_rows), p))  # K2


@pytest.mark.parametrize("name", ["FAST_PARAMS", "DEFAULT_PARAMS", "PBS_PARAMS"])
def test_limb_external_product_probe_vectors_match_the_oracle(cuda, name):
    p = LIMB_PARAMS[name]
    rows_np, digits_np = engine.probe_vectors(p)
    pd = torch.from_numpy(digits_np)
    got = limb_step.external_product(pd.to(torch.int8).to(cuda),
                                     plain.prepare_trgsw_limbs(_u32.from_numpy(rows_np, cuda)), p)
    assert torch.equal(got.cpu(), oracle.external_product(_u32.from_numpy(rows_np), pd))


def test_limb_external_product_refuses_misaligned_digits(cuda):
    p = params.FAST_PARAMS
    table = torch.zeros((2 * p.l, 2, 4, 2 * p.N), dtype=torch.int8, device=cuda)
    buf = torch.zeros((2 * p.l * p.N + 1,), dtype=torch.int8, device=cuda)
    digits = buf[1:].view(1, 2 * p.l, p.N)  # contiguous, one byte past a boundary
    before = limb_step.external_product.launches
    with pytest.raises(ValueError, match="16-byte"):
        limb_step.external_product(digits, table, p)
    assert limb_step.external_product.launches == before


def test_limb_step_kernels_refuse_what_they_do_not_take(cuda):
    for N in (4, 4096):
        p = params.FAST_PARAMS.replace(N=N)
        acc = torch.zeros((1, 2, N), dtype=torch.int32, device=cuda)
        ai = torch.zeros((1,), dtype=torch.int32, device=cuda)
        table = torch.zeros((2 * p.l, 2, 4, 2 * N), dtype=torch.int8, device=cuda)
        for tag, step in LIMB_STEPS.items():
            before = step.launches
            with pytest.raises(ValueError, match="power of two"):
                step(acc, ai, table, p)
            assert step.launches == before, tag


@pytest.mark.parametrize("B", [1, 13, 33])  # 13, 33: ragged last tiles
@pytest.mark.parametrize("name", ["FAST_PARAMS", "DEFAULT_PARAMS"])
def test_limb_probe_kernels_match_plain(cuda, name, B):
    # P6's variants and P5's orders (K6's and K4's kernels with one part
    # changed) against their plain versions, and the pieces that are the
    # probes' own: the digits without rotation, P5's drain product, P6's
    # nodots kernel.  One launch count per step.
    p = getattr(params, name)
    rows, acc, ai, _ = _case(42, 33, p)
    acc, ai = acc[:B], ai[:B]
    table = plain.prepare_trgsw_limbs(_u32.from_numpy(rows))
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    c_acc, c_ai, c_tab = t_acc.to(cuda), t_ai.to(cuda), table.to(cuda)
    for variant, (rotate, dots) in limb_probe.VARIANTS.items():  # P6
        for tm in (128, 256):
            want = limb_probe.variant_step_plain(t_acc, t_ai, table, p, rotate, dots, tm)
            before = limb_probe.step_variant.launches
            got = limb_probe.step_variant(c_acc, c_ai, c_tab, p, variant, tm)
            assert limb_probe.step_variant.launches == before + 1
            assert torch.equal(got.cpu(), want), (variant, tm)
    want = limb_step.cmux_step_plain(t_acc, t_ai, table, p)
    assert torch.equal(limb_probe.step_variant(c_acc, c_ai, c_tab, p, "full").cpu(), want)
    for order in limb_probe.ORDERS:  # P5
        before = limb_probe.step_order.launches
        got = limb_probe.step_order(c_acc, c_ai, c_tab, p, order)
        assert limb_probe.step_order.launches == before + 1
        assert torch.equal(got.cpu(), want), order
    norot = limb_probe.step_digits(c_acc, c_ai, p, rotate=False)
    assert torch.equal(norot.cpu(), limb_probe.step_digits_plain(t_acc, t_ai, p, rotate=False))
    digits = cmux_k.step_digits(c_acc, c_ai, p)
    panel = limb_step.limb_panel(c_tab, p)
    assert torch.equal(limb_probe.drain_product(digits, panel, c_acc, p).cpu(),
                       limb_step.merged_product_plain(digits.cpu(), panel.cpu(), t_acc, p))
    for tm in (128, 256):
        assert torch.equal(limb_probe.nodots(digits, c_acc, p, tm).cpu(),
                           limb_probe.nodots_plain(digits.cpu(), t_acc, p, tm))


@pytest.mark.parametrize("tile", list(int8_gemm.TILES))
def test_int8_gemm_kernel_matches_plain(cuda, tile):
    # the ring's edges: K = DEPTH (one stage), K = (STAGES + 1) x DEPTH (the
    # ring wraps), M and N one tile and several, and more tiles than the
    # persistent grid has blocks at K = (STAGES + 1) x DEPTH, so that a block's
    # next tile starts in the middle of a round of the ring
    bm, bn = int8_gemm.tile_shape(tile)
    depth, wraps = int8_gemm.DEPTH, (int8_gemm.STAGES + 1) * int8_gemm.DEPTH
    rs = np.random.RandomState(43)
    for M, K, N in ((bm, depth, bn), (bm, wraps, bn), (3 * bm, wraps, 2 * bn),
                    (2 * bm, 6144, 3 * bn), (2048, wraps, 4096)):
        d = rs.randint(-128, 128, size=(M, K)).astype(np.int8)
        w = rs.randint(-128, 128, size=(K, N)).astype(np.int8)
        d[0], w[:, 0] = -128, -128  # the largest products
        t_d, t_w = torch.from_numpy(d), torch.from_numpy(w)
        wt = int8_gemm.prepare_rhs(t_w.to(cuda))
        want = int8_gemm.int8_matmul_plain(t_d, t_w)
        before = int8_gemm.int8_matmul.launches
        got = int8_gemm.int8_matmul(t_d.to(cuda), wt, tile)
        assert torch.equal(got.cpu(), want), (M, K, N)
        assert int8_gemm.int8_matmul.launches == before + 1
        # ragged shapes raise, and launch nothing
        for rd, rwt in ((t_d[: M - 1], wt), (t_d[:, : K - 32], wt[:, : K - 32].contiguous()),
                        (t_d, wt[: N - 8])):
            with pytest.raises(ValueError, match="does not divide tile"):
                int8_gemm.int8_matmul(rd.contiguous().to(cuda), rwt, tile)
        assert int8_gemm.int8_matmul.launches == before + 1


@pytest.mark.parametrize("tile", list(int8_gemm.TILES))
def test_int8_gemm_kernel_at_the_exactness_edge(cuda, tile):
    # every product -128 * -128 at K = 2^17 - DEPTH: sums of 2^31 - 2^21
    bm, bn = int8_gemm.tile_shape(tile)
    K = (1 << 17) - int8_gemm.DEPTH
    d = torch.full((bm, K), -128, dtype=torch.int8, device=cuda)
    wt = torch.full((bn, K), -128, dtype=torch.int8, device=cuda)
    got = int8_gemm.int8_matmul(d, wt, tile)
    assert bool((got == K * 16384).all())


@pytest.mark.parametrize("name,B", [("DEFAULT_PARAMS", 1), ("DEFAULT_PARAMS", 13),
                                    ("DEFAULT_PARAMS", 33), ("DEFAULT_PARAMS", 8192),
                                    ("PBS_PARAMS", 13)])  # 13, 33: ragged last tiles
def test_karatsuba_kernels_match_plain_and_k1(cuda, name, B):
    # Every form of P4, P8, P1, P2 and P3 against its plain version (on the
    # card), on a table mapped from random JAX-layout bytes; the exact forms
    # on a table from rows against K1 through the scan layout; each piece
    # (tree digits, leaf panels, leaves, combine) of every form against its
    # plain version.  One launch count per step.
    p = getattr(params, name)
    rows, acc, ai, _ = _case(44, B, p)
    rs = np.random.RandomState(45)
    qd = torch.from_numpy(rs.randint(-128, 128, size=(2, 2 * p.l * 4 * 9, p.N // 2)).astype(np.int8))
    std, a = _u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda)
    flat = karatsuba.scan_enter(std)
    t_rows = _u32.from_numpy(rows, cuda)
    k1 = cmux_k.cmux_step(std, a, plain.prepare_trgsw(t_rows), p)
    for tab, exact_only in ((karatsuba.table_from_qd(qd).to(cuda), False),
                            (karatsuba.prepare_table(t_rows), True)):
        for probe, label, fn, kw, form in karatsuba_probe.calls():
            if exact_only and not form.exact:
                continue
            before = fn.launches
            got = fn(flat, a, tab, p, **kw)
            assert fn.launches == before + 1
            assert torch.equal(got, karatsuba.step_plain(flat, a, tab, p, form)), (probe, label)
            if exact_only:
                assert torch.equal(karatsuba.scan_exit(got), k1), (probe, label)
    # the pieces, form by form (the leaves on every leaf's digits)
    panel = karatsuba_probe.leaf_panel(tab, p)
    assert torch.equal(panel, karatsuba_probe.leaf_panel_plain(tab, p))
    full = karatsuba_probe.tree_digits_plain(flat, a, p)
    for form in karatsuba_probe.FORMS - {karatsuba_probe.ABLATIONS["accio"]}:
        dig = karatsuba_probe.tree_digits(flat, a, p, form)
        want = karatsuba_probe.tree_digits_plain(flat, a, p, form)
        if form.build != "upfront":  # the residue leaves alone
            dig, want = (x[:, list(karatsuba_probe.RESIDUE_LEAVES)] for x in (dig, want))
        assert torch.equal(dig, want), form
        dig = karatsuba_probe.tree_digits_plain(flat, a, p, form)
        leaves = karatsuba_probe.leaves(dig, panel, tab, p, form)
        assert torch.equal(leaves, karatsuba_probe.leaves_plain(dig, panel, tab, p, form)), form
        assert torch.equal(karatsuba_probe.combine(flat, leaves, p, form),
                           karatsuba_probe.combine_plain(flat, leaves, p, form)), form
    # two steps per call: two steps counted, equal to two single steps
    a2 = torch.stack([a, a.flip(0)], dim=1)
    tabs = torch.stack([tab, karatsuba.table_from_qd(qd).to(cuda)])
    before = karatsuba_probe.step_var.launches
    got = karatsuba_probe.step_var(flat, a2, tabs, p, unroll=2)
    assert karatsuba_probe.step_var.launches == before + 2
    one = karatsuba_probe.step_var(flat, a, tabs[0], p)
    assert torch.equal(got, karatsuba_probe.step_var(one, a.flip(0).contiguous(), tabs[1], p))
    # nodots at another tm
    assert torch.equal(karatsuba_probe.step_ablate(flat, a, tab, p, "nodots", tm=64),
                       karatsuba.step_plain(flat, a, tab, p, karatsuba_probe.ABLATIONS["nodots"],
                                            tm=64))


def test_karatsuba_kernel_refuses_what_it_does_not_carry(cuda):
    # N=4096: a leaf size of 1024, past the kernels' 512 (PBS_PARAMS, N=2048,
    # runs since the tensor-core redesign: test_karatsuba_kernels_match_plain_and_k1)
    p = params.DEFAULT_PARAMS.replace(N=4096)
    acc = torch.zeros((1, 2 * p.N), dtype=torch.int32, device=cuda)
    ai = torch.zeros((1,), dtype=torch.int32, device=cuda)
    tab = torch.zeros(karatsuba.table_shape(p), dtype=torch.int8, device=cuda)
    before = karatsuba_probe.step_k2.launches
    with pytest.raises(ValueError, match="power of two in \\[32, 2048\\]"):
        karatsuba_probe.step_k2(acc, ai, tab, p)
    assert karatsuba_probe.step_k2.launches == before


@pytest.mark.parametrize("N", [64, 256, 512])
def test_coissue_forms_at_small_leaves(cuda, N):
    # leaf sizes below one 128-byte slice (ns = 16, 64) and at one (128):
    # the producer's builds on zero-padded digit planes
    p = params.DEFAULT_PARAMS.replace(N=N)
    rows, acc, ai, _ = _case(46, 13, p)
    flat = karatsuba.scan_enter(_u32.from_numpy(acc))
    tab = karatsuba.prepare_table(_u32.from_numpy(rows))
    want = karatsuba.step_plain(flat, torch.from_numpy(ai), tab, p)
    for pipelined in (False, True):
        got = karatsuba_probe.step_coissue(flat.to(cuda), torch.from_numpy(ai).to(cuda),
                                           tab.to(cuda), p, pipelined)
        assert torch.equal(got.cpu(), want), pipelined


@pytest.mark.parametrize("s", [0, 1, 17, 63])
def test_nuss_primitives_kernel_matches_plain(cuda, s):
    rs = np.random.RandomState(47)
    x = _u32.from_numpy(rs.randint(0, 2**32, size=(128, 2048), dtype=np.uint64))
    before = nuss_primitives.nuss_primitives.launches
    got = nuss_primitives.nuss_primitives(x.to(cuda), s)
    assert nuss_primitives.nuss_primitives.launches == before + 1
    assert torch.equal(got.cpu(), nuss_primitives.nuss_primitives_plain(x, s))


@pytest.mark.parametrize("rows", [13, 24576])  # a ragged count; the transform's size
def test_nuss_primitives_kernel_at_the_transform_size_and_ragged_rows(cuda, rows):
    rs = np.random.RandomState(50)
    x = _u32.from_numpy(rs.randint(0, 2**32, size=(rows, 2048), dtype=np.uint64), cuda)
    for s in (0, 1, 17, 63):
        before = nuss_primitives.nuss_primitives.launches
        got = nuss_primitives.nuss_primitives(x, s)
        assert nuss_primitives.nuss_primitives.launches == before + 1
        assert torch.equal(got, nuss_primitives.nuss_primitives_plain(x, s)), s
    misaligned = x.reshape(-1)[1: 1 + 2048].view(1, 2048)  # 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        nuss_primitives.nuss_primitives(misaligned)


def test_seeded_expansion_on_card_equals_cpu(cuda):
    from rustfhe_tpu_torch import tlwe
    from rustfhe_tpu_torch.utils import threefry

    key = np.array([0xFFFFFFFF, 0x80000000], np.uint32)
    for shape in [(), (5, 635), (33, 1025)]:
        got = threefry.random_bits(key, shape, cuda)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), threefry.random_bits(key, shape))
    assert torch.equal(threefry.split(threefry.key_words(key, cuda), 3).cpu(),
                       threefry.split(key, 3))
    assert torch.equal(threefry.fold_in(threefry.key_words(key, cuda), 7).cpu(),
                       threefry.fold_in(key, 7))
    rs = np.random.RandomState(51)
    body = _u32.from_numpy(rs.randint(0, 2**32, size=(4096,), dtype=np.uint64))
    for n in (params.DEFAULT_PARAMS.n, params.PBS_PARAMS.n):
        got = tlwe.expand_seeded(key, body, n, cuda)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), tlwe.expand_seeded(key, body, n))
    ctx = TFHE.new(0, params.TEST_PARAMS, device=cuda)
    bits = rs.randint(0, 2, 64)
    x = ctx.cloud_only().expand_seeded(ctx.encrypt_seeded(bits))
    assert x.device.type == "cuda"
    assert np.array_equal(ctx.decrypt(x).cpu().numpy(), bits)


@pytest.mark.parametrize("name,B", [("matmul", 13), ("matmul", 256), ("matmul_bf16", 13)])
def test_matmul_engines_match_cpu_and_oracle(cuda, name, B):
    p = params.DEFAULT_PARAMS
    eng = engine.get_engine(name)
    rows, _, _, _ = _case(48, B, p)
    rs = np.random.RandomState(49)
    digits = torch.from_numpy(rs.randint(-p.half_bg, p.half_bg, size=(B, 2 * p.l, p.N))
                              .astype(np.int32))
    t_rows = _u32.from_numpy(rows)
    prep = eng.prepare_trgsw(t_rows, p)
    want = eng.external_product_digits(prep, digits, p)
    before = int8_gemm.int8_matmul.launches
    got = eng.external_product_digits(prep.to(cuda), digits.to(cuda), p)
    assert int8_gemm.int8_matmul.launches == before + (name == "matmul")
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, oracle.external_product(t_rows, digits))
    assert engine.select_engine(p, cuda, name) == name


# --------------------------------------------------------------------- #
# The encrypted-integer path: evaluate_encrypted, FheUint, K3 against K1
# --------------------------------------------------------------------- #
def _contexts_on_one_key(seed, p, devices, engine_name="cmux_k"):
    """One raw key set (made on the CPU) prepared on each device: contexts
    whose outputs are comparable word for word."""
    from rustfhe_tpu_torch import keys

    gen = torch.Generator().manual_seed(seed)
    sk = keys.gen_secret_key(gen, p, "cpu")
    bk_raw, ksk_raw = keys.gen_cloud_key_raw(gen, sk, p)
    out = []
    for dev in devices:
        ck = keys.prepare_cloud_key(bk_raw.to(dev), ksk_raw.to(dev), p, engine_name)
        dsk = keys.SecretKey(sk.lv0.to(dev), sk.lv1.to(dev))
        out.append(TFHE(dsk, ck, p, dev, None, engine_name))
    return out


def test_evaluate_encrypted_on_card_equals_cpu(cuda):
    from rustfhe_tpu_torch.apps import circuits

    p = params.TEST_PARAMS
    cpu, card = _contexts_on_one_key(60, p, ["cpu", cuda])
    rs = np.random.RandomState(61)
    cases = rs.randint(0, 2, size=(5, 16))
    cts = cpu.encrypt(cases)
    for circuit, x in ((circuits.ripple_carry_adder(8), cts[0]),         # unbatched
                       (circuits.kogge_stone_adder(8), cts),             # a leading axis
                       (circuits.prefix_comparator(8), cts.reshape(5, 1, 16, -1))):
        want = circuits.evaluate_encrypted(circuit, cpu, x)
        before = cmux_k.cmux_step.launches
        got = circuits.evaluate_encrypted(circuit, card, x.to(cuda))
        assert cmux_k.cmux_step.launches > before
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    got = circuits.evaluate_encrypted(circuits.ripple_carry_adder(8), card, cts.to(cuda),
                                      fixed_width=16)
    dec = card.decrypt(got).cpu().numpy()
    assert np.array_equal(dec, circuits.evaluate_plain(circuits.ripple_carry_adder(8), cases))


def test_fheuint_at_default_params_decrypts_right(cuda):
    p = params.DEFAULT_PARAMS
    ctx = TFHE.new(62, p, device=cuda)
    rs = np.random.RandomState(63)
    av, bv = rs.randint(0, 256, 16).astype(np.uint64), rs.randint(0, 256, 16).astype(np.uint64)
    a, b = ctx.encrypt_uint(av, 8), ctx.encrypt_uint(bv, 8)
    assert a.bits.device.type == "cuda"
    np.testing.assert_array_equal((a + b).decrypt(), (av + bv) & 255)
    np.testing.assert_array_equal(ctx.decrypt(a.lt(b)).cpu().numpy(), av < bv)
    np.testing.assert_array_equal((a * b).decrypt(), (av * bv) & 255)
    sv = av.astype(np.int64) - 128
    expect = np.abs(sv)
    expect[sv == -128] = -128  # wraps, as wrapping_abs does
    np.testing.assert_array_equal(ctx.encrypt_sint(sv, 8).abs_().decrypt(), expect)


def test_latency_mode_integer_add_equals_the_k1_loop(cuda):
    from rustfhe_tpu_torch import FheUint, keys

    p = params.DEFAULT_PARAMS
    ctx = TFHE.new(64, p, device=cuda)
    lat = TFHE(ctx.sk, keys.cloud_key_latency(ctx.ck), p, cuda, None, ctx.engine_name)
    a, b = ctx.encrypt_uint([200, 7], 8), ctx.encrypt_uint([100, 9], 8)
    for sl in (slice(0, 1), slice(0, 2)):
        x, y = FheUint(ctx, a.bits[sl]), FheUint(ctx, b.bits[sl])
        want = x + y
        k1, k3 = cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches
        got = FheUint(lat, x.bits) + FheUint(lat, y.bits)
        assert cmux_k.cmux_step.launches == k1
        assert rotate_all_k.rotate_all.launches == k3 + 7  # one K3 launch per level
        assert torch.equal(got.bits, want.bits)
        np.testing.assert_array_equal(got.decrypt(), [44, 16][: sl.stop])


# --------------------------------------------------------------------- #
# Programmable bootstrapping and the radix integers: a test vector per row
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B", [1, 8, 33])
def test_per_row_test_vectors_at_pbs_params_on_k1_and_k3(cuda, B):
    """At PBS_PARAMS (N=2048, l=4; a shortened rotation of n steps) a test
    vector per row through ``blind_rotate``: the K1 loop equals its plain
    version, and K3 (a latency key) equals the K1 loop, word for word."""
    from rustfhe_tpu_torch import bootstrap, keys

    p = params.PBS_PARAMS.replace(n=24)
    _, a, bk = _rotation_case(90 + B, B, p, cuda)
    rs = np.random.RandomState(91 + B)
    ct = _u32.from_numpy(rs.randint(0, 2**32, size=(B, p.n + 1), dtype=np.uint64), cuda)
    tv = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64), cuda)
    acc, a_steps = bootstrap.rotation_start(ct, tv, p)
    want = rotate_all_k.rotate_all_plain(acc, a_steps, bk, p)
    k1 = cmux_k.cmux_step.launches
    got = bootstrap.blind_rotate(ct, bk, tv, p)
    assert cmux_k.cmux_step.launches == k1 + p.n
    assert torch.equal(got, want)
    k3 = rotate_all_k.rotate_all.launches
    lat = bootstrap.blind_rotate(ct, keys.LatencyBK(bk), tv, p)
    assert rotate_all_k.rotate_all.launches == k3 + 1
    assert torch.equal(lat, got)


def test_pbs_and_radix_on_card_equal_cpu(cuda):
    """PBS_TEST_PARAMS on one key set: per-row tables, pbs_many and a radix
    add on the card (K1; K3 on a latency key) equal the CPU's words."""
    from rustfhe_tpu_torch import keys, pbs
    from rustfhe_tpu_torch.radix import RadixUint

    p = params.PBS_TEST_PARAMS
    cpu, card = _contexts_on_one_key(92, p, ["cpu", cuda])
    lat = TFHE(card.sk, keys.cloud_key_latency(card.ck), p, cuda, None, card.engine_name)
    rs = np.random.RandomState(93)
    xs = rs.randint(0, 8, size=(3, 5))
    ct = pbs.encrypt_int(torch.Generator().manual_seed(94), cpu.sk.lv0, xs, 8, p)
    tables = rs.randint(0, 8, size=(3, 1, 8))
    want = pbs.pbs(cpu.ck, ct, tables, space=8, params=p)
    for c in (card, lat):
        got = pbs.pbs(c.ck, ct.to(cuda), tables, space=8, params=p)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(cpu.decrypt_int(want, 8).numpy(), tables[:, 0][
        np.arange(3)[:, None], xs])
    tabs2 = rs.randint(0, 8, size=(2, 8))
    many = pbs.pbs_many(cpu.ck, ct, tabs2, space=8, params=p, unsafe=True)
    got = pbs.pbs_many(card.ck, ct.to(cuda), tabs2, space=8, params=p, unsafe=True)
    assert torch.equal(got.cpu(), many)
    av, bv = rs.randint(0, 64, 4).astype(np.uint64), rs.randint(0, 64, 4).astype(np.uint64)
    gen = torch.Generator().manual_seed(95)
    a, b = (RadixUint(cpu, pbs.encrypt_int(gen, cpu.sk.lv0, RadixUint._to_digits(v, 3), 8, p))
            for v in (av, bv))
    s_cpu = (a + b).digits
    for c in (card, lat):
        s = RadixUint(c, a.digits.to(cuda)) + RadixUint(c, b.digits.to(cuda))
        assert torch.equal(s.digits.cpu(), s_cpu)
    np.testing.assert_array_equal(RadixUint(cpu, s_cpu).decrypt(), (av + bv) & 63)


def test_pbs_params_context_on_card(cuda):
    """``TFHE.new(seed, PBS_PARAMS)`` on the card picks "cmux_k": a space-8
    lookup with a table per row decodes right, and a radix 4-bit add at
    batch 1 on K3 equals the K1 loop's word for word."""
    from rustfhe_tpu_torch import keys
    from rustfhe_tpu_torch.radix import RadixUint

    p = params.PBS_PARAMS
    ctx = TFHE.new(95, p, device=cuda)
    assert ctx.engine_name == "cmux_k"
    rs = np.random.RandomState(96)
    xs, tables = rs.randint(0, 8, size=64), rs.randint(0, 8, size=(64, 8))
    k1 = cmux_k.cmux_step.launches
    out = ctx.apply_lut(ctx.encrypt_int(xs, 8), tables, 8)
    assert cmux_k.cmux_step.launches == k1 + p.n
    np.testing.assert_array_equal(ctx.decrypt_int(out, 8).cpu().numpy(), tables[np.arange(64), xs])
    lat = TFHE(ctx.sk, keys.cloud_key_latency(ctx.ck), p, cuda, None, ctx.engine_name)
    a, b = ctx.encrypt_radix([13], 2), ctx.encrypt_radix([9], 2)
    want = a + b
    k1, k3 = cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches
    got = RadixUint(lat, a.digits) + RadixUint(lat, b.digits)
    assert rotate_all_k.rotate_all.launches == k3 + 2 and cmux_k.cmux_step.launches == k1
    assert torch.equal(got.digits, want.digits)
    np.testing.assert_array_equal(got.decrypt(), [6])  # 13 + 9 = 22 mod 16
    x = ctx.encrypt_radix([0xB5], 4)  # an odd shift: one level of 8 lanes, one K3 launch
    k3 = rotate_all_k.rotate_all.launches
    got = RadixUint(lat, x.digits).shift_left(1)
    assert rotate_all_k.rotate_all.launches == k3 + 1
    assert torch.equal(got.digits, x.shift_left(1).digits)
    np.testing.assert_array_equal(got.decrypt(), [0x6A])


@pytest.mark.parametrize("B", [1, 13, 4096])
@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS"])
def test_cmux_step_panel_matches_plain(cuda, name, B):
    """K1's step on a prebuilt panel (the hybrid key's steps: digits and
    product, no panel kernel) = cmux_step_plain on the step's table, with
    one count a call and no key_panel launch."""
    p = getattr(params, name)
    rows, acc, ai, _ = _case(41, B, p)
    rows[0, 0, :2] = [0x80808080, 0xFFFFFFFF]
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    want = cmux_k.cmux_step_plain(_u32.from_numpy(acc), torch.from_numpy(ai), key, p)
    panel = cmux_k.key_panel(key.to(cuda), p)
    before = (cmux_k.cmux_step_panel.launches, cmux_k.key_panel.launches)
    got = cmux_k.cmux_step_panel(_u32.from_numpy(acc, cuda), torch.from_numpy(ai).to(cuda),
                                 panel, p)
    assert (cmux_k.cmux_step_panel.launches, cmux_k.key_panel.launches) == (before[0] + 1,
                                                                           before[1])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("full", [False, True])
def test_hybrid_rotation_equals_the_k1_loop(cuda, full):
    """A hybrid key's blind rotation at DEFAULT_PARAMS (n = 635: 317 pairs
    and the tail) = the K1 loop on the standard key, word for word; the
    panel kernel runs on the 318 even and tail steps (none with full
    panels), the panel step on the others."""
    from rustfhe_tpu_torch import bootstrap, keys, trlwe

    p = params.DEFAULT_PARAMS
    gen = torch.Generator(device=cuda).manual_seed(43)
    _, ck = keys.gen_keys(gen, p, cuda)
    hk = keys.cloud_key_hybrid(ck, p, full_panels=full)
    rs = np.random.RandomState(44)
    ct = _u32.from_numpy(rs.randint(0, 2**32, size=(64, p.n + 1), dtype=np.uint64), cuda)
    tv = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=cuda))
    want = bootstrap.blind_rotate(ct, ck.bk, tv, p)
    k1, kp = cmux_k.cmux_step.launches, cmux_k.cmux_step_panel.launches
    got = bootstrap.blind_rotate(ct, hk.bk, tv, p)
    assert cmux_k.cmux_step.launches - k1 == (0 if full else p.n // 2 + p.n % 2)
    assert cmux_k.cmux_step_panel.launches - kp == (p.n if full else p.n // 2)
    assert torch.equal(got, want)


def test_public_key_encryption_and_gates_at_default_on_card(cuda):
    """Public-key encryption at DEFAULT_PARAMS on the card: a batch of
    4096 under the 1272-row key decrypts right, and every ``gates.hom_*``
    on public ciphertexts (K1) equals the same gate on the CPU (K1's plain
    version) word for word, on 8 lanes."""
    from rustfhe_tpu_torch import gates
    from rustfhe_tpu_torch.keys import CloudKey

    p = params.DEFAULT_PARAMS
    ctx = TFHE.new(0, p, device=cuda)
    pk = ctx.make_public_key()
    assert pk.shape == (1272, p.n + 1) and pk.is_cuda
    rs = np.random.RandomState(16)
    bits = rs.randint(0, 2, 4096)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = ctx.cloud_only().encrypt_public(pk, bits, gen=gen)
    assert cts.shape == (4096, p.n + 1) and cts.is_cuda
    assert np.array_equal(ctx.decrypt(cts).cpu().numpy(), bits)
    c, x, y = (cts[i * 8:(i + 1) * 8] for i in range(3))
    host_ck = CloudKey(bk=ctx.ck.bk.cpu(), ksk=ctx.ck.ksk.cpu())
    fns = dict(gates.GATES_2IN, **{"not": gates.hom_not, "mux": gates.hom_mux})
    before = cmux_k.cmux_step.launches
    for name, fn in fns.items():
        args = {"not": (x,), "mux": (c, x, y)}.get(name, (x, y))
        got = fn(ctx.ck, *args, params=p, engine_name="cmux_k")
        assert got.is_cuda
        want = fn(host_ck, *(a.cpu() for a in args), params=p)
        assert torch.equal(got.cpu(), want), name
    assert cmux_k.cmux_step.launches - before == (4 + 1 + 2) * p.n
    got = ctx.decrypt(gates.hom_mux(ctx.ck, c, x, y, params=p)).cpu().numpy()
    assert np.array_equal(got, np.where(bits[:8] == 1, bits[16:24], bits[8:16]))


def test_onehot_key_switch_on_p9_equals_identity_key_switch(cuda):
    from rustfhe_tpu_torch.benches import keyswitch_probe

    forms, ct = keyswitch_probe.setup(256, params.DEFAULT_PARAMS, cuda)
    int8_gemm.reset_counters()
    got = forms.onehot_int8(ct)
    assert int8_gemm.int8_matmul.launches == 1
    assert torch.equal(got, forms.current(ct))


def test_grouped_nand_at_default_decodes_right(cuda):
    from rustfhe_tpu_torch.benches import multibit_probe

    p = params.DEFAULT_PARAMS
    cmux_k.reset_counters()
    bad, batch = multibit_probe.check_correctness(p, batch=64, seed=5, engine="cmux_k",
                                                  device=cuda)
    assert bad == 0, f"{bad}/{batch} grouped-2 NANDs wrong"
    assert cmux_k.external_product.launches == 3 * (p.n // 2) + p.n % 2
