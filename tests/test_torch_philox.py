"""Port: ops/philox.py -- Philox4x32-10 in plain PyTorch against the known
answers of the Random123 distribution, against a numpy implementation written
here, and the layout of the dropout bits (one call = four neighbouring
columns; hidden and attention sites never share a counter)."""
import numpy as np
import pytest
import torch

from aspire_tpu_torch.ops import philox

KNOWN = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def philox_numpy(counter, key):
    """Reference in numpy uint64 arithmetic (products of 32-bit values fit)."""
    c = [np.asarray(x, np.uint64) for x in counter]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    mask = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c


@pytest.mark.parametrize("counter,key,want", KNOWN)
def test_known_answers(counter, key, want):
    got = philox.philox4x32_10(
        [torch.tensor([x], dtype=torch.int64) for x in counter], key)
    assert tuple(int(x) for x in got) == want


def test_matches_numpy_on_random_counters(rng):
    counter = rng.integers(0, 2 ** 32, (4, 500), dtype=np.uint64)
    key = (int(rng.integers(0, 2 ** 32)), int(rng.integers(0, 2 ** 32)))
    got = philox.philox4x32_10(
        [torch.from_numpy(c.astype(np.int64)) for c in counter], key)
    want = philox_numpy(counter, key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_hidden_bits_layout():
    seed, site, rows, cols = 0x0123456789ABCDEF, 5, 3, 10   # ragged last group
    bits = philox.hidden_bits(seed, site, rows, cols)
    assert bits.shape == (rows, cols) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for r in range(rows):
        for c in range(cols):
            words = philox_numpy(
                (philox.counter_word0(philox.KIND_HIDDEN, site), 0, r, c // 4), key)
            assert int(bits[r, c]) == int(words[c % 4])


def test_attention_bits_layout_and_kind():
    seed, site, b, nh, t = 77, 2, 2, 3, 6
    bits = philox.attention_bits(seed, site, b, nh, t)
    assert bits.shape == (b, nh, t, t)
    words = philox_numpy(
        (philox.counter_word0(philox.KIND_ATTENTION, site), 1 * nh + 2, 4, 5 // 4),
        (seed, 0))
    assert int(bits[1, 2, 4, 5]) == int(words[5 % 4])
    # a hidden site of the same number, seed and position draws other bits
    hidden = philox.hidden_bits(seed, site, t, t)
    assert not torch.equal(hidden, bits[0, 0])
    assert philox.counter_word0(philox.KIND_HIDDEN, site) \
        != philox.counter_word0(philox.KIND_ATTENTION, site)
    with pytest.raises(ValueError, match="site"):
        philox.counter_word0(philox.KIND_HIDDEN, 1 << 24)


def test_sites_and_seeds_draw_distinct_streams():
    a = philox.hidden_bits(1, 0, 8, 16)
    assert torch.equal(a, philox.hidden_bits(1, 0, 8, 16))
    assert not torch.equal(a, philox.hidden_bits(2, 0, 8, 16))
    assert not torch.equal(a, philox.hidden_bits(1, 1, 8, 16))
    assert not torch.equal(a, philox.hidden_bits(1 << 32, 0, 8, 16))  # high word


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_threshold_and_keep_rate(p):
    assert philox.keep_threshold(p) == int(round(p * 2.0 ** 32))
    bits = philox.hidden_bits(3, 1, 512, 768)
    rate = float((bits >= philox.keep_threshold(p)).float().mean())
    assert abs(rate - (1 - p)) < 5e-3          # 393k draws: 3 sigma ~ 2.4e-3


def test_bits_of_any_32_bit_form_read_as_unsigned(rng):
    raw = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint32)
    as_i64 = torch.from_numpy(raw.astype(np.int64))
    for form in (torch.from_numpy(raw.view(np.int32)), as_i64,
                 torch.from_numpy(raw)):
        assert torch.equal(philox.bits_to_int64(form), as_i64)
