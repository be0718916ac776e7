"""One wgmma product of each form the bf16 flash kernels run, alone,
against an fp64 ``torch.matmul`` on the card.

``csrc/wgmma_probe.cu`` runs one 64-row tile of each:

* SS, both operands bf16 in shared memory, K-major (S = Q K^T, dP = dO V^T
  and their transposes): the products of bf16 values are exact in fp32, so
  the tile reads within 1e-6 of its largest value (~1.6e-7 on an H100);
* RS, an fp32 A operand in registers as the hi + lo bf16 pair
  ``sm90::pack_a_split`` makes, B bf16 MN-major (dV += P^T dO,
  dK += dS^T Q, dQ += dS K): the pair leaves each A element within 2^-16
  of itself, so the tile reads within 2e-5 (~3e-6 on an H100), where one
  bf16 A value reads ~1.5e-3.

At dh 80 (hubert-xlarge's heads, the flash kernels' dh-80 instances)
each operand row is two 64-column boxes, the second filled with zeros by
TMA past column 80: SS reads K = 80 in five k16 steps, RS writes
m64n80k16 across the two boxes. The forward's two forms are the cases at
128 rows: S over a 128-key tile (n 128, K 80) and O += P V with B over
128 rows, its boxes 16 KB apart (K 128, n80).

A wrong descriptor, swizzle or fragment layout reads O(1). The kernels are
CUDA for sm_90a and have no CPU version: these tests skip without a card.
On a machine with an H100 (``--noconftest``: the tests' conftest imports
JAX, which that machine need not have):
``PYTHONPATH=src python -m pytest -s --noconftest
tests/test_torch_wgmma_probe.py``.
"""
import ctypes

import pytest
import torch

from repro_torch.kernels import common

SS_TOL = 1e-6
RS_SPLIT_TOL = 2e-5
ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs a CUDA kernel for sm_90a: needs an H100")
    return torch.device("cuda")


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n,dh", [(32, 64), (32, 128), (64, 64), (64, 128),
                                  (32, 80), (64, 80), (128, 80)])
def test_ss_product_matches_matmul(card, n, dh):
    g = torch.Generator().manual_seed(n * 1000 + dh)
    a = torch.randn(64, dh, generator=g).bfloat16().to(card)
    b = torch.randn(n, dh, generator=g).bfloat16().to(card)
    out = torch.zeros(64, n, device=card)
    ss = common.load("wgmma_probe", "probe_ss", ARGS)
    assert ss(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, dh) == 0
    torch.cuda.synchronize()
    err = rel_err(out, a.double() @ b.double().T)
    print(f"SS m64n{n} K {dh}: rel err {err:.3e}")
    assert err <= SS_TOL


@pytest.mark.parametrize("k,dh", [(32, 128), (64, 64), (64, 128), (32, 80),
                                  (64, 80), (128, 80)])
def test_rs_split_product_matches_matmul(card, k, dh):
    g = torch.Generator().manual_seed(k * 1000 + dh)
    a = (torch.rand(64, k, generator=g) / k).to(card)
    b = torch.randn(k, dh, generator=g).bfloat16().to(card)
    out = torch.zeros(64, dh, device=card)
    rs = common.load("wgmma_probe", "probe_rs", ARGS)
    assert rs(a.data_ptr(), b.data_ptr(), out.data_ptr(), k, dh) == 0
    torch.cuda.synchronize()
    ref = a.double() @ b.double()
    err = rel_err(out, ref)
    single = rel_err(a.bfloat16().double() @ b.double(), ref)
    print(f"RS split m64n{dh} K {k} MN-major: rel err {err:.3e} "
          f"(one bf16 A: {single:.3e})")
    assert err <= RS_SPLIT_TOL < single
