"""The integer-to-float conversion of ``csrc/dequant.cuh`` (K5's weights,
K3's int8 and int4 pages), modelled in numpy step by step with the
constants read from the header itself: a byte permute into the mantissa
of 2^23 and one subtraction give every int8 value and every int4 nibble
exactly, and two such floats pack into one bf16x2 word exactly. The
kernels run only on the card; this holds their arithmetic here."""

import os
import re

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(__file__), os.pardir,
                      "distkeras_tpu_torch", "csrc", "dequant.cuh")


def _constants():
    with open(HEADER) as f:
        text = f.read()
    words = {k: int(v, 16) for k, v in re.findall(
        r"constexpr uint32_t (k\w+) = (0x[0-9A-Fa-f]+)u;", text)}
    floats = {k: np.float32(v) for k, v in re.findall(
        r"constexpr float (k\w+) = ([0-9.]+)f;", text)}
    lut = int(re.search(r"lop3\.b32 [^;]*?(0x[0-9a-fA-F]+);", text)
              .group(1), 16)
    return words, floats, lut


WORDS, FLOATS, LUT = _constants()


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte n of the result is byte ``(s >> 4n) &
    7`` of the eight bytes of (x, y), x's first."""
    src = (np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << 32))
    out = np.zeros_like(np.asarray(x, np.uint64))
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * sel)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out.astype(np.uint32)


def lop3(a, b, c, lut):
    """PTX ``lop3.b32``: each result bit is bit ``4a + 2b + c`` of the
    look-up table, a, b and c being the inputs' bits."""
    a, b, c = (np.asarray(v, np.uint32) for v in (a, b, c))
    out = np.zeros_like(a)
    for idx in range(8):
        if (lut >> idx) & 1:
            ma = a if idx & 4 else ~a
            mb = b if idx & 2 else ~b
            mc = c if idx & 1 else ~c
            out |= ma & mb & mc
    return out


def as_float(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def magic(biased, i):
    return as_float(byte_perm(biased, WORDS["kMagic"],
                              WORDS["kPermByte"] | i))


def test_lop3_is_and_then_xor():
    rs = np.random.RandomState(0)
    a, b, c = (rs.randint(0, 2 ** 32, 1000, dtype=np.uint64)
               .astype(np.uint32) for _ in range(3))
    np.testing.assert_array_equal(lop3(a, b, c, LUT), (a & b) ^ c)


@pytest.mark.parametrize("i", range(4))
def test_int8_byte_permute_is_exact(i):
    """Every int8 value in byte i of a word (the other bytes random)
    comes out as itself."""
    rs = np.random.RandomState(i)
    v = np.arange(-128, 128)
    other = rs.randint(0, 2 ** 32, v.size, dtype=np.uint64) \
        .astype(np.uint32) & ~np.uint32(0xFF << (8 * i))
    w = other | ((v & 0xFF).astype(np.uint32) << np.uint32(8 * i))
    f = magic(w ^ np.uint32(WORDS["kSign8"]), i) - FLOATS["kBias8"]
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, v.astype(np.float32))


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("i", range(4))
def test_int4_nibble_mask_is_exact(i, hi):
    """Every int4 value in the low or high nibble of byte i (the other
    nibble and bytes random) comes out as itself: shift, one lop3, the
    permute, one subtraction."""
    rs = np.random.RandomState(10 + i + 4 * hi)
    n = np.tile(np.arange(-8, 8), 16)
    sh = 8 * i + (4 if hi else 0)
    w = rs.randint(0, 2 ** 32, n.size, dtype=np.uint64).astype(np.uint32)
    w &= ~np.uint32(0xF << sh)
    w |= (n & 0xF).astype(np.uint32) << np.uint32(sh)
    b = lop3(w >> np.uint32(4 if hi else 0), WORDS["kNibble"],
             WORDS["kSign4"], LUT)
    f = magic(b, i) - FLOATS["kBias4"]
    np.testing.assert_array_equal(f, n.astype(np.float32))


def test_two_small_integers_pack_to_bf16x2_exactly():
    """Floats of integers in [-128, 127] keep their value in the high 16
    bits (bf16), and the high-half permute packs lo below hi."""
    v = np.arange(-128, 128).astype(np.float32)
    lo, hi = v, v[::-1].copy()
    packed = byte_perm(lo.view(np.uint32), hi.view(np.uint32),
                       WORDS["kPermHigh"])
    got_lo = as_float((packed & np.uint32(0xFFFF)) << np.uint32(16))
    got_hi = as_float(packed & np.uint32(0xFFFF0000))
    np.testing.assert_array_equal(got_lo, lo)
    np.testing.assert_array_equal(got_hi, hi)


def test_bf16_pages_widen_by_a_shift():
    """K3 reads bf16 pages two to a word: the low one shifted up 16 bits,
    the high one masked, each the float of the bf16."""
    rs = np.random.RandomState(3)
    x = rs.randn(512).astype(np.float32)
    bf = (x.view(np.uint32) >> np.uint32(16)).astype(np.uint32)
    words = bf[0::2] | (bf[1::2] << np.uint32(16))
    lo = as_float(words << np.uint32(16))
    hi = as_float(words & np.uint32(0xFFFF0000))
    trunc = as_float(bf << np.uint32(16))
    np.testing.assert_array_equal(lo, trunc[0::2])
    np.testing.assert_array_equal(hi, trunc[1::2])
