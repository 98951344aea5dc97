"""The Hopper attention kernel's launch plan and operand rules, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there).  What surrounds it is plain Python and runs here:
``plan`` (warpgroups, ring depth, shared memory, persistent grid) at every
shape the port launches, the rule that pads a head dim only when a row
stride is not a multiple of 16 bytes, the packed argument layout, and the
wrapper's CPU path on the strided (B, S, H, D) views the model passes.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.flash_attention import kernel as K

QWEN = (20, 20, 128)        # H, Hkv, head dim: qwen1.5-4b
ZAMBA = (32, 32, 64)        # zamba2-1.2b's shared attention block
GEMMA2 = (8, 4, 256)        # gemma2-2b
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
        / "flash_attention.cu")

# (B, H, Hkv, Sq, Skv, D, Dv): the served prompt lengths, P = 2048, the
# chip_smoke parity shapes, every head dim, a narrow Dv (after the pad to 8)
SHAPES = (
    [(1, *QWEN[:2], p, p, QWEN[2], QWEN[2]) for p in (16, 100, 128, 200)]
    + [(1, *ZAMBA[:2], p, p, ZAMBA[2], ZAMBA[2]) for p in (96, 300, 384)]
    + [(1, 20, 20, 2048, 2048, 128, 128), (2, 20, 20, 2048, 2048, 128, 128),
       (2, 8, 2, 300, 300, 64, 64), (2, 8, 8, 64, 192, 128, 128),
       (1, 32, 8, 256, 256, 128, 128), (1, 16, 16, 1000, 1000, 128, 128)]
    + [(1, 4, 4, 128, 128, d, d) for d in (16, 32, 64, 128)]
    + [(1, 20, 20, 128, 128, 128, 40), (1, 32, 32, 384, 384, 64, 32)]
    + [(1, *GEMMA2[:2], p, p, GEMMA2[2], GEMMA2[2])
       for p in (16, 128, 200, 4200)]
    + [(1, 8, 4, 300, 300, 192, 192), (1, 8, 4, 128, 128, 256, 248)]
)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plan_covers_the_queries_and_fits(shape):
    B, H, Hkv, Sq, Skv, D, Dv = shape
    p = K.plan(*shape)
    rows = K.TILE * p.nwg
    assert p.items == B * H * -(-Sq // rows)          # every query row
    assert (p.items - 1) // (B * H) * rows < Sq       # and no empty tile
    assert 1 <= p.grid <= min(p.items, K.SM_COUNT * p.blocks_per_sm)
    assert p.kd == -(-D // 64) and p.vb == -(-Dv // 64)
    assert 2 <= p.stages <= K.MAX_STAGES
    assert p.smem == K.ring_bytes(p.nwg, p.kd, p.vb, p.stages)
    assert p.smem <= K.SMEM_LIMIT
    # the blocks a SM that the ring was sized for fit its shared memory
    assert p.blocks_per_sm * (p.smem + 1024) <= K.SMEM_SM
    # the plan is a function of the shapes alone
    K.plan.cache_clear()
    assert K.plan(*shape) == p


def test_plan_picks_two_warpgroups_only_where_they_fill_the_card():
    assert K.plan(1, 20, 20, 128, 128, 128, 128).nwg == 1     # 40 items
    assert K.plan(1, 32, 32, 384, 384, 64, 64).nwg == 1       # 192 items
    big = K.plan(1, 20, 20, 2048, 2048, 128, 128)             # 320 items
    assert (big.nwg, big.grid, big.blocks_per_sm) == (2, K.SM_COUNT, 1)
    # two one-warpgroup blocks a SM once the items outnumber the SMs
    assert K.plan(1, 32, 32, 384, 384, 64, 64).blocks_per_sm == 2
    assert K.plan(1, 20, 20, 128, 128, 128, 128).blocks_per_sm == 1


@pytest.mark.parametrize("bad", [(0, 1, 1, 8, 8, 64, 64),
                                 (1, 6, 4, 8, 8, 64, 64),
                                 (1, 4, 4, 8, 8, 136, 64),
                                 (1, 4, 4, 8, 8, 64, 256),
                                 (1, 8, 4, 8, 8, 264, 264)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        K.plan(*bad)


@pytest.mark.parametrize("P", [16, 128, 200, 4200])
def test_plan_at_gemma2_head_dim_256(P):
    """One consumer warpgroup a block (a 64 x 256 f32 O is 128 registers
    a thread), one block a SM and two K/V stages: 197,696 B."""
    p = K.plan(1, *GEMMA2[:2], P, P, GEMMA2[2], GEMMA2[2])
    assert (p.nwg, p.kd, p.vb, p.stages, p.blocks_per_sm) == (1, 4, 4, 2, 1)
    assert p.smem == K.ring_bytes(1, 4, 4, 2) == 197_696
    assert p.items == 8 * -(-P // 64) and p.grid == min(p.items, K.SM_COUNT)


@pytest.mark.parametrize("kd,vb", [(4, 2), (2, 4), (3, 1), (1, 4), (4, 3),
                                   (3, 4)])
def test_unsupported_wide_pairs_raise_naming_the_pair(kd, vb):
    with pytest.raises(ValueError, match=rf"\({kd}, {vb}\)"):
        K.plan(1, 8, 4, 64, 64, 64 * kd, 64 * vb)


def test_ring_bytes_is_the_c_formula():
    """``ring_bytes`` against ``smem_bytes`` in csrc/flash_attention.cu,
    its expression and constants read from the source, at every plan the
    kernel compiles (and a few more stages)."""
    src = CSRC.read_text()
    body = re.search(r"constexpr int smem_bytes\(int nwg, int kd, int vb,"
                     r"\s*int stages\) \{\s*return (.*?);", src, re.S)
    consts = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
              for n in ("QROWS", "BK", "DMAX")}
    assert consts["DMAX"] == K.DMAX
    expr = " ".join(body.group(1).split())
    for nwg, kd, vb in [(1, 1, 1), (1, 1, 2), (1, 2, 1), (1, 2, 2), (2, 1, 1),
                        (2, 2, 2), (1, 3, 3), (1, 4, 4)]:
        for stages in range(2, 5):
            want = eval(expr, {}, dict(consts, nwg=nwg, kd=kd, vb=vb,
                                       stages=stages))
            assert K.ring_bytes(nwg, kd, vb, stages) == want
    # the C entry's dispatch compiles exactly the wide pairs the plan takes
    wide = {(int(a), int(b)) for a, b in re.findall(
        r"launch<1, (\d), (\d), FAULT>", src)}
    assert wide == set(K.COMPILED_WIDE)


def _bshd(shape, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(dtype)


@pytest.mark.parametrize("width,pads", [(128, False), (64, False), (16, False),
                                        (126, True), (40, False), (29, True)])
def test_pad_only_when_a_row_stride_is_not_16_bytes(width, pads):
    x = _bshd((1, 8, 4, width)).transpose(1, 2)    # the model's view
    assert K.tma_ready(x) == (not pads)
    y = K.tma_operand(x)
    if not pads:
        assert y is x
        return
    assert y.is_contiguous() and y.shape[-1] == -(-width // 8) * 8
    assert torch.equal(y[..., :width], x)
    assert not y[..., width:].any()


def test_pad_rule_checks_strides_alignment_and_layout():
    x = _bshd((2, 8, 4, 64))
    assert K.tma_ready(x) and K.tma_ready(x.transpose(1, 2))
    assert not K.tma_ready(x[..., 1:])                 # start not aligned
    assert K.tma_operand(x[..., 1:]).shape[-1] == 64
    assert not K.tma_ready(x.transpose(2, 3))          # head dim strided
    assert K.tma_operand(x.transpose(2, 3)).is_contiguous()
    assert not K.tma_ready(x[:, :, :1].expand(2, 8, 4, 64))   # stride 0
    # a dimension of extent 1 may have any stride
    assert K.tma_ready(x[:1, :, :1])


def test_packed_arguments_match_the_c_struct():
    # ``static_assert(sizeof(Params) == 200)`` in csrc/flash_attention.cu:
    # six pointers, nine strides, sixteen ints, four floats, no padding
    assert K._HEAD.size == 6 * 8
    assert K._HEAD.size + K._TAIL.size == 200


CASES = [
    ("causal", (1, 128, 4, 4, 32), dict(causal=True)),
    ("window_softcap", (2, 128, 4, 2, 32),
     dict(causal=True, window=40, softcap=30.0)),
    ("gqa", (1, 128, 8, 2, 64), dict(causal=True)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_strided_views_give_the_contiguous_bits(name, shape, kw, dtype):
    B, S, H, Hkv, D = shape
    q = _bshd((B, S, H, D), dtype, seed=1).transpose(1, 2)
    k = _bshd((B, S, Hkv, D), dtype, seed=2).transpose(1, 2)
    v = _bshd((B, S, Hkv, D), dtype, seed=3).transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_attention_bhsd(q, k, v, bq=64, bk=64, **kw)
    want = flash_attention_bhsd(q.contiguous(), k.contiguous(),
                                v.contiguous(), bq=64, bk=64, **kw)
    assert got.shape == (B, H, S, D)
    assert torch.equal(got, want)
