"""nander: logic-expression parser, evaluator and console REPL.

Counterpart of ``rustfhe_tpu/apps/nander.py``, itself a re-implementation
of the reference ``nander`` crate:
  * ``Logip`` protocol — required NAND, defaulted NOT/AND/OR/XOR as NAND
    compositions (reference ``nander/src/lib.rs:19-38``),
  * ``LogicExpr`` AST + recursive evaluator (lib.rs:64-89),
  * recursive-descent parser over the grammar ``0 1 ! & | ^ $ ( )`` with
    left-associative binary chains (lib.rs:90-172),
  * interactive console (``nander/src/main.rs:20-70``).

Leaves parse to *trivial* (noiseless) ciphertexts exactly as the reference's
``AsLogic`` does (tlwe.rs:80-87); gates still bootstrap.  The console runs
on the CUDA card, and raises when there is none, unless the environment
sets ``RUSTFHE_FORCE_CPU`` (or the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass


class Logip:
    """Logical processor base: NAND is required; the rest default to NAND
    compositions exactly as the reference trait does (lib.rs:25-37)."""

    def nand(self, lhs, rhs):
        raise NotImplementedError

    def logic_true(self):
        raise NotImplementedError

    def logic_false(self):
        raise NotImplementedError

    def not_(self, x):
        return self.nand(x, x)

    def and_(self, lhs, rhs):
        return self.not_(self.nand(lhs, rhs))

    def or_(self, lhs, rhs):
        return self.nand(self.not_(lhs), self.not_(rhs))

    def xor(self, lhs, rhs):
        x = self.nand(lhs, rhs)
        return self.nand(self.nand(lhs, x), self.nand(x, rhs))


class PlainLogic(Logip):
    """Plaintext Logip for tests and cross-checks."""

    def nand(self, lhs, rhs):
        return 1 - (lhs & rhs)

    def not_(self, x):
        return 1 - x

    def and_(self, lhs, rhs):
        return lhs & rhs

    def or_(self, lhs, rhs):
        return lhs | rhs

    def xor(self, lhs, rhs):
        return lhs ^ rhs

    def logic_true(self):
        return 1

    def logic_false(self):
        return 0


class FheLogic(Logip):
    """Logip over a TFHE context (the analogue of ``impl Logip for TFHE``,
    lib.rs:40-62): uses native gates, leaves as trivial ciphertexts."""

    def __init__(self, ctx):
        self.ctx = ctx

    def nand(self, lhs, rhs):
        return self.ctx.nand(lhs, rhs)

    def not_(self, x):
        return self.ctx.not_(x)

    def and_(self, lhs, rhs):
        return self.ctx.and_(lhs, rhs)

    def or_(self, lhs, rhs):
        return self.ctx.or_(lhs, rhs)

    def xor(self, lhs, rhs):
        return self.ctx.xor(lhs, rhs)

    def logic_true(self):
        return self.ctx.trivial(1)

    def logic_false(self):
        return self.ctx.trivial(0)


# ----------------------------- AST ----------------------------------- #
@dataclass
class Nand:
    lhs: "Expr"
    rhs: "Expr"


@dataclass
class Not:
    lhs: "Expr"


@dataclass
class And:
    lhs: "Expr"
    rhs: "Expr"


@dataclass
class Or:
    lhs: "Expr"
    rhs: "Expr"


@dataclass
class Xor:
    lhs: "Expr"
    rhs: "Expr"


@dataclass
class Leaf:
    value: bool


Expr = Nand | Not | And | Or | Xor | Leaf


class ParseError(ValueError):
    pass


def parse_logic_expr(text: str) -> Expr:
    """Parse per the reference grammar (lib.rs:90-172).

    binary := mono (('&'|'|'|'^'|'$') mono)*   (left-associative)
    mono   := '!' mono | elem
    elem   := '0' | '1' | '(' binary ')'
    NOTE the reference quirk: Nand(lhs, rhs) *swaps* operands at eval time
    (lib.rs:74-76 evaluates rhs as lhs); since NAND is commutative the
    result is identical, so we keep natural order.
    """
    s = "".join(text.split())
    pos = 0

    def peek():
        return s[pos] if pos < len(s) else None

    def advance():
        nonlocal pos
        c = s[pos]
        pos += 1
        return c

    def parse_binary():
        lhs = parse_mono()
        while True:
            c = peek()
            if c == "&":
                advance()
                lhs = And(lhs, parse_mono())
            elif c == "|":
                advance()
                lhs = Or(lhs, parse_mono())
            elif c == "^":
                advance()
                lhs = Xor(lhs, parse_mono())
            elif c == "$":
                advance()
                lhs = Nand(lhs, parse_mono())
            else:
                return lhs

    def parse_mono():
        if peek() == "!":
            advance()
            return Not(parse_mono())
        return parse_elem()

    def parse_elem():
        c = peek()
        if c is None:
            raise ParseError("invalid element. this is none")
        advance()
        if c == "0":
            return Leaf(False)
        if c == "1":
            return Leaf(True)
        if c == "(":
            e = parse_binary()
            if peek() != ")":
                raise ParseError("braket is not closed")
            advance()
            return e
        raise ParseError("invalid element")

    expr = parse_binary()
    if pos != len(s):
        raise ParseError(f"unexpected trailing input at {pos}: {s[pos:]!r}")
    return expr


def eval_logic_expr(pros, expr: Expr):
    """Recursive evaluation (lib.rs:72-89)."""
    match expr:
        case Leaf(value=v):
            return pros.logic_true() if v else pros.logic_false()
        case Not(lhs=l):
            return pros.not_(eval_logic_expr(pros, l))
        case Nand(lhs=l, rhs=r):
            return pros.nand(eval_logic_expr(pros, l), eval_logic_expr(pros, r))
        case And(lhs=l, rhs=r):
            return pros.and_(eval_logic_expr(pros, l), eval_logic_expr(pros, r))
        case Or(lhs=l, rhs=r):
            return pros.or_(eval_logic_expr(pros, l), eval_logic_expr(pros, r))
        case Xor(lhs=l, rhs=r):
            return pros.xor(eval_logic_expr(pros, l), eval_logic_expr(pros, r))
    raise TypeError(f"not an expression: {expr!r}")


RULES = """nander: evaluate logical expressions over encrypted bits.
  literals: 0 1    operators: ! (not) & (and) | (or) ^ (xor) $ (nand)
  parentheses group; binary operators chain left-associatively.
  example: (1 & 0) ^ !0
  pipelined: K ';'-separated expressions evaluate as ONE fused batch
  (one readback for all K results — amortizes transport).
Ctrl-D to exit."""


def console_device(device=None):
    """The console's device: ``device`` when given; else the CPU when the
    environment sets ``RUSTFHE_FORCE_CPU``, and the CUDA card otherwise
    (raises when there is none)."""
    import torch

    if device is not None:
        return torch.device(device)
    if os.environ.get("RUSTFHE_FORCE_CPU"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the nander console runs on a CUDA card and "
                           "torch.cuda.is_available() is False; set "
                           "RUSTFHE_FORCE_CPU=1 to run it on the CPU")
    return torch.device("cuda")


def nander_console(params=None, device=None, stdin=None, stdout=None,
                   latency_mode: bool = False, keyfile: str | None = None,
                   engine_name=None):
    """Interactive console (main.rs:20-70): keygen, then parse/eval/decrypt.

    ``device``: see ``console_device``.  ``latency_mode`` marks the
    bootstrapping key for the single-launch blind rotation (K3,
    ``keys.cloud_key_latency``): an interactive line evaluates a handful
    of gates at a time, the regime where one launch per rotation beats n.
    ``keyfile``: on-disk raw-key cache prefix (--keyfile PATH on the CLI;
    ``utils.serialization.cached_keys``): keygen runs once and later
    consoles load the keys.  A cached console reuses the SAME secret key
    across runs; point different trust domains at different key files.
    ``engine_name``: as ``TFHE.new``'s (``None``: the engine rule)."""
    from ..context import TFHE
    from ..params import DEFAULT_PARAMS
    from .replprog import FusedEvaluator

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    params = params or DEFAULT_PARAMS
    dev = console_device(device)

    print(RULES, file=stdout)
    print("selecting engine + generating keys...", file=stdout, flush=True)
    t0 = time.perf_counter()
    ctx = TFHE.new(int(time.time()), params, dev, latency_mode=latency_mode,
                   keyfile=keyfile, engine_name=engine_name)
    print(f"keys ready in {time.perf_counter() - t0:.1f}s "
          f"(engine {ctx.engine_name})", file=stdout, flush=True)

    pros = FheLogic(ctx)
    # One bootstrap batch per level (see replprog.py).  On the card a level
    # of up to 32 lanes costs about what one lane does, so wide pipelined
    # lines share it; on the CPU padding lanes are real work, so the wire
    # file stays narrow.  Expressions wider than the evaluator's capacities
    # take the generic gate-by-gate path.
    wide = dev.type == "cuda"
    fused = FusedEvaluator(ctx, width=32 if wide else 8,
                           max_wires=128 if wide else 64)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        if ";" in line:
            # Pipelined mode: K ';'-separated expressions lower into ONE
            # shared wire file, K results for one readback.
            try:
                exprs = [parse_logic_expr(s.strip())
                         for s in line.split(";") if s.strip()]
            except ParseError as e:
                print(f"parse error: {e}", file=stdout, flush=True)
                continue
            t0 = time.perf_counter()
            # Greedy chunking: K may exceed the wire file's lane width —
            # evaluate in the largest fused batches that fit; anything that
            # does not fit even alone takes the generic gate-by-gate path.
            bits = []
            i = 0
            while i < len(exprs):
                chunk = exprs[i : i + fused.width]
                while chunk and not fused.fits_many(chunk):
                    chunk = chunk[:-1]
                if chunk:
                    bits.extend(fused.eval_bits(chunk))
                    i += len(chunk)
                    continue
                e = exprs[i]
                if fused.fits(e):
                    bits.append(fused.eval_bit(e))
                else:
                    ct = eval_logic_expr(pros, e)
                    bits.append(int(ctx.decrypt(ct)))
                i += 1
            dt = (time.perf_counter() - t0) * 1e6
            print(f"res: {' '.join(str(b) for b in bits)}", file=stdout)
            print(f"time: {dt:.0f} us total, "
                  f"{dt / max(len(bits), 1):.0f} us/expr", file=stdout,
                  flush=True)
            continue
        try:
            expr = parse_logic_expr(line)
        except ParseError as e:
            print(f"parse error: {e}", file=stdout, flush=True)
            continue
        t0 = time.perf_counter()
        if fused.fits(expr):
            bit = fused.eval_bit(expr)
        else:
            ct = eval_logic_expr(pros, expr)
            bit = int(ctx.decrypt(ct))
        dt = (time.perf_counter() - t0) * 1e6
        print(f"res: {bit}", file=stdout)
        print(f"time: {dt:.0f} us", file=stdout, flush=True)


def hom_nand_profile(params=None, device=None, iters: int = 100, engine_name=None):
    """Profile harness (reference ``nander`` 'profile' feature,
    lib.rs:174-198): one timed NAND, then ``iters`` NANDs, with the
    amortized time per gate, on the engine ``engine_name`` (``None``: the
    engine rule)."""
    import torch

    from ..context import TFHE
    from ..params import DEFAULT_PARAMS

    params = params or DEFAULT_PARAMS
    dev = console_device(device)
    ctx = TFHE.new(0, params, dev, engine_name=engine_name)
    c1 = ctx.encrypt(1)
    c0 = ctx.encrypt(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    out = ctx.nand(c0, c1)
    sync()
    print(f"hom_nand: {(time.perf_counter() - t0) * 1e6:.0f} us (first call, incl. kernel build)")

    t0 = time.perf_counter()
    for _ in range(iters):
        out = ctx.nand(c0, c1)
    sync()
    dt = time.perf_counter() - t0
    print(f"{iters} nands: {dt * 1e3:.1f} ms total, {dt / iters * 1e6:.0f} us/gate")
    if int(ctx.decrypt(out)) != 1:
        raise AssertionError("NAND(0, 1) did not decrypt to 1")


def main(argv: list[str]) -> None:
    """``python -m rustfhe_tpu_torch.apps.nander [--latency] [--keyfile
    PATH] [--profile]``: the console on stdin/stdout, or the profile."""
    if "--profile" in argv:
        hom_nand_profile()
        return
    kf = None
    if "--keyfile" in argv:
        i = argv.index("--keyfile")
        if i + 1 >= len(argv):
            sys.exit("--keyfile needs a path prefix argument")
        kf = argv[i + 1]
    nander_console(latency_mode="--latency" in argv, keyfile=kf)


if __name__ == "__main__":
    # ``python -m`` runs this file as ``__main__``: a second copy of every
    # AST class beside the canonical ``rustfhe_tpu_torch.apps.nander`` that
    # replprog pattern-matches against.  Delegate to the canonical module
    # so that one set of classes exists.
    from rustfhe_tpu_torch.apps import nander as _canonical

    _canonical.main(sys.argv[1:])
