"""The port's MoE FFN and ring-buffer KV cache against the reference.

``moe_ffn``: the reference's ``init_moe`` params (``params_from_jax``) and
numpy inputs go through ``repro.models.moe.moe_ffn`` and the port's, in
float32: outputs to 2e-5 absolute and 1e-4 of the largest magnitude (other
summation orders); the three aux metrics to the same; and the routing
itself (the capacity, which tokens are kept) equal, since ``drop_frac`` is
a count.  Cases cover top-1 and top-2, the shared expert, silu and gelu,
``combine_first``, and capacity factor 0.5, which drops tokens.

``cache_write_prefill``: a prefill's k/v written into a cache of Smax
slots at S < Smax, S = Smax and S > Smax (the ring buffer) equals the
reference's cache bit for bit (a copy moves values unchanged).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe

from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attention
from repro_torch.models import moe
from _torch_threads import one_torch_thread  # noqa: F401

D, FF, E = 64, 96, 4
TOL = (2e-5, 1e-4)

# (top_k, shared expert, act, combine_first, capacity_factor)
CASES = [(2, False, "silu", False, 1.25), (1, True, "silu", False, 1.25),
         (2, True, "gelu", False, 1.25), (2, False, "silu", True, 1.25),
         (1, False, "gelu", True, 1.25), (2, False, "silu", False, 0.5),
         (1, True, "silu", True, 0.5), (2, True, "gelu", True, 0.5)]


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= TOL[0] and d <= TOL[1] * max(np.abs(want).max(), 1.0), d


def _params(shared, seed=0):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), D, FF, E, jnp.float32,
                         shared=shared)
    host = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_jax(host, device="cpu")


@pytest.mark.parametrize("top_k,shared,act,combine_first,cf", CASES)
def test_moe_ffn_matches_reference(top_k, shared, act, combine_first, cf):
    jp, tp = _params(shared)
    x = np.random.default_rng(1).normal(size=(2, 24, D)).astype(np.float32)
    kw = dict(top_k=top_k, capacity_factor=cf, act=act,
              combine_first=combine_first)
    want_y, want_aux = ref_moe.moe_ffn(jp, jnp.asarray(x), **kw)
    got_y, got_aux = moe.moe_ffn(tp, torch.from_numpy(x), **kw)
    _close(got_y, want_y)
    assert set(got_aux) == set(want_aux) == {"aux_loss", "z_loss",
                                             "drop_frac"}
    for k in want_aux:
        _close(got_aux[k], want_aux[k])
    # drop_frac is a count over (B, S, K): equal routing gives it exactly
    assert float(got_aux["drop_frac"]) == pytest.approx(
        float(want_aux["drop_frac"]), abs=1e-7)
    if cf < 1:
        assert float(got_aux["drop_frac"]) > 0


def test_moe_capacity_drop_accounting():
    """The reference's ``test_moe_capacity_drop_accounting``
    (tests/test_models.py) on the port: capacity 0.5 drops a fraction of
    the assignments and reports it; capacity 8 drops none."""
    cfg = ref_get_config("mixtral-8x7b").reduced()
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff, 4,
                         jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                         device="cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (2, 32, cfg.d_model), jnp.float32)))
    y, aux = moe.moe_ffn(tp, x, top_k=2, capacity_factor=0.5)
    assert y.shape == x.shape
    assert 0.0 < float(aux["drop_frac"]) < 1.0
    y2, aux2 = moe.moe_ffn(tp, x, top_k=2, capacity_factor=8.0)
    assert float(aux2["drop_frac"]) == 0.0


@pytest.mark.parametrize("S,top_k,cf", [(1, 1, 1.25), (1, 2, 1.25),
                                        (24, 2, 1.25), (5, 2, 1.0),
                                        (3, 1, 0.5), (4200, 2, 1.25),
                                        (128, 1, 1.25)])
def test_capacity_is_the_references(S, top_k, cf):
    """The reference's formula (Python ``round``: half to even), from the
    unpadded length: e.g. S = 4200, top-2, 8 experts -> round(1312.5) =
    1312."""
    E_ = 8
    want = int(max(top_k, round(S * top_k * cf / E_)))
    assert moe.capacity(S, top_k, cf, E_) == min(want, S * top_k)
    assert moe.capacity(4200, 2, 1.25, 8) == 1312


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = moe._top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("S", [5, 8, 13])
def test_cache_write_prefill_matches_reference(S):
    """Smax = 8: S < Smax writes slots [0, S); S = Smax fills the cache;
    S > Smax keeps the last 8 tokens at slot pos % 8."""
    smax, hkv, dh = 8, 2, 4
    rng = np.random.default_rng(S)
    k = rng.normal(size=(1, S, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(1, S, hkv, dh)).astype(np.float32)
    want = ref_attention.cache_write_prefill(
        ref_attention.init_kv_cache(1, smax, hkv, dh, jnp.float32),
        jnp.asarray(k), jnp.asarray(v))
    cache = attention.init_kv_cache(2, 1, smax, hkv, dh, torch.float32,
                                    "cpu")
    attention.cache_write_prefill(cache, 1, torch.from_numpy(k),
                                  torch.from_numpy(v))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[name][1].numpy(),
                                      np.asarray(want[name]))
    assert (cache["pos"][0] == -1).all()        # the other layer untouched
    if S > smax:
        assert sorted(cache["pos"][1, 0].tolist()) == list(range(S - smax,
                                                                S))
