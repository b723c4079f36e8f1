"""The attention kernels' dropout draw (``csrc/dropout.cuh``, ``csrc/tc_mma.cuh``)
emulated on the CPU, against ``dropout_keep_reference``.

The kernels compare the Philox word with an integer threshold computed on the
host, start each draw from a row's precomputed rounds (``dropout::row_state``,
``dropout::keep4``), and hand the bits to the accumulator layout of
``mma.sync`` by one shuffle a slab (``tc::keep_slab``). Each step is
emulated here in int64 tensors holding 32-bit words, as the device code does
it, and must give the reference's bits. Imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from streamspeech_tpu_torch.kernels import attention as A
from tests.torch_threads import one_torch_thread  # noqa: F401

M32 = 0xFFFFFFFF
M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
STEP = 1677722 * 2.0 ** -24  # a rate on a step of the threshold (exact in float32)
RATES = [2.0 ** -24, 1e-6, 0.05, 0.1, float(np.nextafter(np.float32(0.1), np.float32(1))),
         0.3, 0.5, 0.9, 1 - 2.0 ** -24, float(np.nextafter(np.float32(STEP), np.float32(0))),
         STEP, float(np.nextafter(np.float32(STEP), np.float32(1)))]


def threshold(rate: float) -> int:
    """``dropout::threshold``: ceil(rate·2²⁴) in double, shifted back by 8 bits."""
    return math.ceil(float(np.float32(rate)) * 2.0 ** 24) << 8


@pytest.mark.parametrize("rate", RATES)
def test_threshold_gives_the_float_compare_for_every_draw(rate):
    """For every one of the 2²⁴ values of bits >> 8, whatever the low 8 bits:
    bits >= threshold(rate) is (bits >> 8)·2⁻²⁴ >= rate in float32."""
    u = torch.arange(1 << 24, dtype=torch.int64)
    want = u.to(torch.float32) * (1.0 / (1 << 24)) >= torch.tensor(rate, dtype=torch.float32)
    thr = threshold(rate)
    assert 0 < thr <= (1 << 32) - 256
    for low in (0, 255):
        assert torch.equal((u << 8 | low) >= thr, want)


def test_threshold_steps_where_the_compare_does():
    assert threshold(0.0) == 0
    assert threshold(np.nextafter(np.float32(STEP), np.float32(0))) == threshold(STEP)
    assert threshold(np.nextafter(np.float32(STEP), np.float32(1))) == threshold(STEP) + 256


def _mul(m, x):
    return A._mulhilo32(m, x)


def row_state(k0, k1, b, h, row):
    """``dropout::row_state``: (x2, y1, y2, y3, y4) of one row's counter."""
    hb, lb = _mul(M0, b)
    hr, lr = _mul(M1, row)
    c0 = hr ^ h ^ k0
    x2 = hb ^ k1
    y1 = lr ^ ((k0 + W0) & M32)
    h0, l0 = _mul(M0, c0)
    c2 = h0 ^ lb ^ ((k1 + W1) & M32)
    h1, l1 = _mul(M1, c2)
    return (x2, y1, h1 ^ ((k0 + 2 * W0) & M32), l0 ^ ((k1 + 2 * W1) & M32),
            l1 ^ ((k0 + 3 * W0) & M32))


def keep4(state, k0, k1, cg, thr):
    """``dropout::keep4``: bit e = column 4 cg + e kept."""
    x2, y1, y2, y3, y4 = state
    hi, c1 = _mul(M1, x2 ^ cg)
    c0 = hi ^ y1
    hi, lo = _mul(M0, c0)
    c0, c2, c3 = c1 ^ y2, hi ^ y3, lo
    h0, l0 = _mul(M0, c0)
    h1, l1 = _mul(M1, c2)
    c0, c1, c2, c3 = h1 ^ y4, l1, h0 ^ c3 ^ ((k1 + 3 * W1) & M32), l0
    for k in range(4, 10):
        h0, l0 = _mul(M0, c0)
        h1, l1 = _mul(M1, c2)
        c0, c1, c2, c3 = (h1 ^ c1 ^ ((k0 + k * W0) & M32), l1,
                          h0 ^ c3 ^ ((k1 + k * W1) & M32), l0)
    return sum((c >= thr).to(torch.int64) << e for e, c in enumerate((c0, c1, c2, c3)))


def kernel_mask(seed: int, b: int, h: int, tq: int, tk: int, rate: float):
    """The mask as the kernels draw it: warps of 16 rows by 8-column slabs,
    lane (g, q) drawing row r0 + g (+ 8 on odd q) and the columns 4 (col / 4 +
    q / 2) ... + 3 of each slab, the pair's bits handed over by
    ``tc::keep_slab``'s shuffle and read back as accumulator element e."""
    k0, k1 = seed & M32, (seed >> 32) & M32
    thr = threshold(rate)
    rows, cols = -(-tq // 16) * 16, -(-tk // 8) * 8

    def ax(n, dim):                            # arange on axis `dim` of 6
        shape = [1] * 6
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64).view(shape)

    bb, hh, r0, col = ax(b, 0), ax(h, 1), 16 * ax(rows // 16, 2), 8 * ax(cols // 8, 3)
    g, q = ax(8, 4), ax(4, 5)
    state = row_state(k0, k1, bb, hh, r0 + g + 8 * (q & 1))
    own = keep4(state, k0, k1, col // 4 + (q >> 1), thr)
    other = own[..., [1, 0, 3, 2]]             # __shfl_xor_sync(own, 1)
    frag = torch.where((q & 1) == 1, ((other >> 2) & 3) | (own & 12),
                       (own & 3) | ((other & 3) << 2))
    mask = torch.zeros(b, h, rows, cols, dtype=torch.bool)
    for e in range(4):
        mask[bb, hh, r0 + g + 8 * (e >> 1), col + 2 * q + (e & 1)] = ((frag >> e) & 1).bool()
    return mask[:, :, :tq, :tk]


@pytest.mark.parametrize("rate", [0.1, 0.5, STEP])
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2, 2 ** 32 + 7, 2 ** 40 + 3])
def test_kernel_draw_equals_the_reference_mask(seed, rate):
    """The hoisted rows, the integer compare and the fragment hand-over give
    the reference's bits; seeds past 2³² use the key's high word."""
    got = kernel_mask(seed, 2, 3, 40, 72, rate)
    want = A.dropout_keep_reference(seed, 2, 3, 40, 72, rate)
    assert torch.equal(got, want)
