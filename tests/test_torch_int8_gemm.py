"""The int8 tensor-core GEMM's layout arithmetic (``engine/int8_gemm.py``)
and the "matmul" engine's padding around it (``engine/matmul.py``), on the
CPU.

The kernel itself (``csrc/int8_gemm.cu``) runs only on the card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it to the plain
version; here the wrapper's shared-memory count is checked against the
kernel's arithmetic and the card's limit, and ``MatmulEngine.product``'s
padding of ragged rows, depth and columns word for word against a float64
product (tolerance zero: every sum is an integer far below 2^53).
"""

import numpy as np
import pytest
import torch

from rustfhe_tpu_torch import params
from rustfhe_tpu_torch.engine import int8_gemm
from rustfhe_tpu_torch.engine.matmul import MatmulEngine

SMEM_OPTIN = 232448  # the opt-in shared memory of one block on an H100


@pytest.mark.parametrize("tile", list(int8_gemm.TILES))
def test_smem_bytes_follow_the_ring(tile):
    # 1024 bytes of alignment slack, STAGES stages of (bm + bn) rows of DEPTH
    # bytes, and a full and an empty 8-byte mbarrier per stage.
    bm, bn = int8_gemm.tile_shape(tile)
    want = {"64x64": 1024 + 4 * 128 * 128 + 64, "128x128": 1024 + 4 * 256 * 128 + 64,
            "128x256": 1024 + 4 * 384 * 128 + 64}[tile]
    assert int8_gemm.smem_bytes(tile) == want
    assert want == int8_gemm.ALIGN + int8_gemm.STAGES * (bm + bn) * int8_gemm.DEPTH \
        + 2 * int8_gemm.STAGES * 8
    assert want <= SMEM_OPTIN


def test_tiles_and_depth():
    assert int8_gemm.DEPTH == 128 and int8_gemm.STAGES == 4
    assert [int8_gemm.tile_shape(t) for t in int8_gemm.TILES] == [(64, 64), (128, 128),
                                                                   (128, 256)]
    assert int8_gemm.TILE in int8_gemm.TILES
    with pytest.raises(ValueError, match="unknown tile"):
        int8_gemm.smem_bytes("256x256")


@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "FAST_PARAMS", "TEST_PARAMS"])
def test_depth_divides_the_engine_depth(name):
    # the external product's contraction depth 2L*N needs no padding
    p = getattr(params, name)
    assert (2 * p.l * p.N) % int8_gemm.DEPTH == 0


def test_default_tile_is_the_engines():
    # int8_matmul's default tile (128x256) is the one the "matmul" engine pads to
    assert int8_gemm.TILE == "128x256"
    rs = np.random.RandomState(5)
    d = torch.from_numpy(rs.randint(-128, 128, size=(128, 256)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-128, 128, size=(256, 256)).astype(np.int8))
    got = int8_gemm.int8_matmul(d, int8_gemm.prepare_rhs(w))
    assert torch.equal(got, int8_gemm.int8_matmul_plain(d, w))
    with pytest.raises(ValueError, match="does not divide tile 128x256"):
        int8_gemm.int8_matmul(d[:64], int8_gemm.prepare_rhs(w))
    with pytest.raises(ValueError, match="does not divide tile 128x256"):
        int8_gemm.int8_matmul(d, int8_gemm.prepare_rhs(w[:, :128]))


@pytest.mark.parametrize("D", [6144, 200])  # the DEFAULT step's depth, and a ragged one
@pytest.mark.parametrize("M", [1, 127, 129])
def test_product_pads_and_cuts_back(M, D):
    # rows to the tile's 128, depth to DEPTH and 300 columns to 512, then
    # the output cut back to (M, 300), word for word
    rs = np.random.RandomState(M * 7 + D)
    d = torch.from_numpy(rs.randint(-32, 33, size=(M, D)).astype(np.int32))
    d[0, :2] = torch.tensor([-32, 32], dtype=torch.int32)
    wt = torch.from_numpy(rs.randint(-128, 128, size=(300, D)).astype(np.int8))
    wt[0, 0] = -128
    before = int8_gemm.int8_matmul.launches
    got = MatmulEngine().product(d, wt)
    assert int8_gemm.int8_matmul.launches == before  # the CPU runs the plain version
    want = (d.to(torch.float64) @ wt.t().to(torch.float64)).to(torch.int32)
    assert got.shape == (M, 300) and got.dtype == torch.int32
    assert torch.equal(got, want)
