"""The port's Fig. 4 checksum against the reference's, bit for bit.

The same numpy inputs go through the reference's ``checksum_ref``,
``checksum(route="interpret")`` (the Pallas kernel in interpret mode) and
``checksum_tree``, and through the port's plain ``checksum_ref``, its
blocked replica ``checksum_ref_blocked``, the ``CHECKSUM`` op's routes
(HW on a CPU tensor runs the kernel's plain version) and
``checksum_tree``.  Tolerance 0: the checksum is an integer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum import checksum as ref_checksum
from repro.kernels.checksum import checksum_ref as ref_checksum_ref
from repro.kernels.checksum import checksum_tree as ref_checksum_tree
from repro.kernels.checksum import popcount_fig4 as ref_popcount_fig4

from repro_torch.kernels.checksum import (CHECKSUM, as_words, checksum,
                                          checksum_popcount, checksum_ref,
                                          checksum_ref_blocked, checksum_tree,
                                          checksum_tree_ref, popcount_fig4)
from repro_torch.viscosity import HW, INTERPRET, SW

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16),
          "int32": (jnp.int32, torch.int32),
          "uint8": (jnp.uint8, torch.uint8),
          "bool": (jnp.bool_, torch.bool)}


def _pair(rng, shape, name):
    """The same values as a jax array and a torch tensor (bit for bit)."""
    jdt, tdt = DTYPES[name]
    x = jnp.asarray(rng.normal(size=shape) * 100).astype(jdt)
    if name == "bfloat16":   # numpy has no bf16: carry the uint16 bits
        bits = np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))
        t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(x).copy())
    assert t.dtype == tdt
    return x, t


def _popcount_np(t: torch.Tensor) -> int:
    """Independent oracle: numpy's unpackbits over the raw bytes."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return int(np.unpackbits(raw).sum()) & 0xFFFFFFFF


# shapes of the reference's test, and lengths that cross the TPU kernel's
# 64x128-word block
@pytest.mark.parametrize("shape", [(33, 17), (5, 7, 3), (1024, 9),
                                   (2, 8193)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_checksum_matches_reference(rng, shape, dtype):
    x, t = _pair(rng, shape, dtype)
    want = int(ref_checksum_ref(x))
    if dtype in ("float32", "bool"):   # the Pallas kernel, interpreted
        assert want == int(ref_checksum(x, route="interpret"))
    assert int(checksum_ref(t)) == want
    assert int(checksum_ref_blocked(t)) == want
    for route in (SW, HW, INTERPRET):
        assert int(checksum(t, route=route)) == want, route
    assert int(checksum_popcount(t)) == want
    assert want == _popcount_np(t)


def test_word_view_and_fig4_match_reference(rng):
    w = rng.integers(0, 2 ** 32, size=(512,), dtype=np.uint64)
    got = popcount_fig4(torch.from_numpy(w.astype(np.int64)))
    want = ref_popcount_fig4(jnp.asarray(w.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x, t = _pair(rng, (3, 5), "bfloat16")
    from repro.kernels.checksum.ref import as_words as ref_as_words
    np.testing.assert_array_equal(as_words(t).numpy(),
                                  np.asarray(ref_as_words(x)))
    # 8-byte items: two words each, zero-extended
    d = torch.tensor([-1.5, 2.0], dtype=torch.float64)
    assert as_words(d).shape == (4,) and int(as_words(d).min()) >= 0
    assert int(checksum_ref(d)) == _popcount_np(d)


def test_views_and_strides_count_their_bytes():
    u8 = torch.arange(37, dtype=torch.uint8)
    assert int(checksum_popcount(u8[1:])) == _popcount_np(u8[1:].clone())
    m = torch.randn(9, 5, generator=torch.Generator().manual_seed(1))
    assert not m.t().is_contiguous()
    assert int(checksum_popcount(m.t())) == int(checksum_ref(m))
    assert int(checksum_ref(torch.zeros(0))) == 0
    assert int(checksum_ref_blocked(torch.zeros(0))) == 0


@pytest.mark.parametrize("n", [8191, 8192, 8193])
def test_block_edges_match_reference_interpret(rng, n):
    x, t = _pair(rng, (n,), "int32")
    want = int(ref_checksum(x, route="interpret"))
    assert int(checksum_ref_blocked(t)) == want == int(checksum_ref(t))


def test_tree_follows_the_reference_leaf_order(rng):
    a, ta = _pair(rng, (8,), "float32")
    b, tb = _pair(rng, (3, 4), "bfloat16")
    c, tc = _pair(rng, (5,), "int32")
    trees = [
        ({"y": a, "x": b}, {"y": ta, "x": tb}),          # unsorted dict
        ({"z": (a, None, [b, c]), "a": c},
         {"z": (ta, None, [tb, tc]), "a": tc}),
        ((a, b), (ta, tb)),
    ]
    for ref_tree, tree in trees:
        want = int(ref_checksum_tree(ref_tree))
        assert checksum_tree(tree) == want
        assert checksum_tree_ref(tree) == want
    # order-sensitive, as the reference's
    assert checksum_tree({"x": ta, "y": tb}) != checksum_tree(
        {"x": tb, "y": ta})


def test_tree_fold_wraps_mod_2_32(rng):
    leaves = [_pair(rng, (64, 64), "float32") for _ in range(6)]
    want = int(ref_checksum_tree([x for x, _ in leaves]))
    assert checksum_tree([t for _, t in leaves]) == want
    assert want < 2 ** 32


def test_registration_and_routes():
    assert CHECKSUM.tol == 0.0
    t = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        checksum_popcount(t.to("meta"))
