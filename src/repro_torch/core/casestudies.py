"""The paper's case studies (§V) as staged PyTorch accelerators.

Port of the reference's ``core/casestudies.py``.  Each case study is a
StagedAccelerator whose stage decomposition follows the paper: FFT = 6
butterfly stages (radix-2 DIT, N=64); AES-128 = 11 stages (initial
AddRoundKey + 9 full rounds + final round) or 3 stages (keyexp+2 rounds /
4 rounds / 4 rounds + final); DCT = 10-stage 2-D 8x8 butterfly pipeline
(rows -> transpose -> cols -> transpose -> scale).

Both lowerings of a stage are the same PyTorch math on the input's device
(the Viscosity equivalence contract is trivially exact); what tells HW
from SW at run time is fault injection, exactly the role the pass-through
accelerator plays in the paper.  The AES stages' canary compare
(``tol=0.0``) is the Fig. 4 checksum, so on the card it runs the Hopper
checksum kernel.  Constructors take ``device`` (default: the card): the
stages' constants live there and their canaries are drawn for it.
"""
from __future__ import annotations

import functools
import math
import numpy as np
import torch

from repro_torch.core.oobleck import StagedAccelerator
from repro_torch.core.stage import Port, Stage
from repro_torch.device import DeviceLike, resolve_device


# ================================================================== FFT
def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _fft_stage(x: torch.Tensor, stage: int, n: int) -> torch.Tensor:
    """One radix-2 DIT butterfly stage on (..., n) complex."""
    m = 2 << stage                     # butterfly span after this stage
    half = m // 2
    k = torch.arange(half, dtype=torch.float32, device=x.device)
    tw = torch.exp(-2j * math.pi * k / m).to(x.dtype)   # complex64
    xs = x.reshape(x.shape[:-1] + (n // m, m))
    even = xs[..., :half]
    odd = xs[..., half:] * tw
    out = torch.cat([even + odd, even - odd], dim=-1)
    return out.reshape(x.shape)


def fft_accelerator(n: int = 64, *, device: DeviceLike = None
                    ) -> StagedAccelerator:
    stages_n = n.bit_length() - 1
    perm = torch.as_tensor(_bit_reverse_perm(n),        # int64 index
                           device=resolve_device(device))
    port = (Port((4, n), torch.complex64),)

    def mk(idx):
        if idx == 0:
            def f(x):
                return _fft_stage(x.index_select(-1, perm), 0, n)
        else:
            f = functools.partial(_fft_stage, stage=idx, n=n)
        return Stage(name=f"fft_s{idx}", sw=f, hw=f, ports=port, tol=1e-4,
                     device=device)

    return StagedAccelerator("fft", [mk(i) for i in range(stages_n)])


def fft_reference(x):
    return torch.fft.fft(x, dim=-1)


# ================================================================== AES
_SBOX = np.array([
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16],
    dtype=np.uint8)
_SHIFT = np.array([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])
_RCON = np.array([0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,0x1b,0x36],
                 dtype=np.uint8)


def aes_key_schedule(key16: np.ndarray) -> np.ndarray:
    """(16,) uint8 -> (11, 16) round keys (host-side, numpy)."""
    w = [key16[i * 4:(i + 1) * 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = _SBOX[t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.stack([np.concatenate(w[4 * r:4 * r + 4]) for r in range(11)])


def _xtime(b):
    hi = (b >> 7) & 1                 # uint8 throughout: << wraps mod 256
    return ((b << 1) & 0xFF) ^ (hi * 0x1B)


def _mix_columns(x):
    s = x.reshape(x.shape[:-1] + (4, 4))           # 4 columns of 4 bytes
    a0, a1, a2, a3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    t = a0 ^ a1 ^ a2 ^ a3
    m0 = a0 ^ t ^ _xtime(a0 ^ a1)
    m1 = a1 ^ t ^ _xtime(a1 ^ a2)
    m2 = a2 ^ t ^ _xtime(a2 ^ a3)
    m3 = a3 ^ t ^ _xtime(a3 ^ a0)
    return torch.stack([m0, m1, m2, m3], dim=-1).reshape(x.shape)


def _aes_round(x, rk, sbox, shift, *, final=False):
    x = sbox[x.long()]                # SubBytes
    x = x[..., shift]                 # ShiftRows
    if not final:
        x = _mix_columns(x)
    return x ^ rk


def aes_accelerator(key16: np.ndarray, n_stages: int = 11, *,
                    device: DeviceLike = None) -> StagedAccelerator:
    dev = resolve_device(device)
    rks = torch.as_tensor(aes_key_schedule(np.asarray(key16, np.uint8)),
                          device=dev)
    sbox = torch.as_tensor(_SBOX, device=dev)
    shift = torch.as_tensor(_SHIFT, device=dev)
    port = (Port((4, 16), torch.uint8),)

    def round_fn(r):
        def f(x):
            if r == 0:
                return x ^ rks[r]
            return _aes_round(x, rks[r], sbox, shift, final=(r == 10))
        return f

    rounds = [round_fn(r) for r in range(11)]
    if n_stages == 11:
        groups = [[r] for r in range(11)]
    elif n_stages == 3:
        # paper: keyexp + first two rounds | 4 rounds | 4 rounds (+final)
        groups = [[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10]]
    else:
        raise ValueError(n_stages)

    def compose(idxs):
        def f(x):
            for r in idxs:
                x = rounds[r](x)
            return x
        return f

    stages = [Stage(name=f"aes_s{i}", sw=compose(g), hw=compose(g),
                    ports=port, tol=0.0, device=device)
              for i, g in enumerate(groups)]
    return StagedAccelerator(f"aes{n_stages}", stages)


# ================================================================== DCT
_C = np.array([np.cos(np.pi * k / 16) for k in range(8)])  # C_k = cos(k pi/16)


def _dct8_butterfly1(x):
    """x (..., 8): even/odd split butterflies (a = x_i + x_{7-i}, b = diff)."""
    xr = x.flip(-1)
    a = x[..., :4] + xr[..., :4]
    b = x[..., :4] - xr[..., :4]
    return torch.cat([a, b], dim=-1)


def _dct8_butterfly2(x):
    a, b = x[..., :4], x[..., 4:]
    c0 = a[..., 0] + a[..., 3]
    c1 = a[..., 1] + a[..., 2]
    c2 = a[..., 1] - a[..., 2]
    c3 = a[..., 0] - a[..., 3]
    return torch.cat([torch.stack([c0, c1, c2, c3], -1), b], dim=-1)


_ODD = np.zeros((4, 4))
for _k, _xk in enumerate((1, 3, 5, 7)):
    for _n in range(4):
        _ODD[_k, _n] = np.cos(np.pi * (2 * _n + 1) * _xk / 16)
_ODD = _ODD.astype(np.float32)
# float32 constants, as the reference's float64 numpy scalars become under
# JAX's default 32-bit mode
_C32 = [float(np.float32(c)) for c in _C]


def _dct8_rotate(x, odd_m):
    """Unnormalized 8-pt DCT-II outputs: X_k = sum_n x_n cos(pi(2n+1)k/16)."""
    c, b = x[..., :4], x[..., 4:]
    X0 = c[..., 0] + c[..., 1]
    X4 = (c[..., 0] - c[..., 1]) * _C32[4]
    X2 = c[..., 3] * _C32[2] + c[..., 2] * _C32[6]
    X6 = c[..., 3] * _C32[6] - c[..., 2] * _C32[2]
    odd = torch.einsum("...n,kn->...k", b, odd_m)
    return torch.stack([X0, odd[..., 0], X2, odd[..., 1], X4, odd[..., 2],
                        X6, odd[..., 3]], dim=-1)


def _transpose88(x):
    return x.transpose(-1, -2)


def dct_accelerator(*, device: DeviceLike = None) -> StagedAccelerator:
    """10-stage 2-D 8x8 DCT-II: 3 row butterfly stages, transpose, 3 column
    stages, transpose, 2 scaling stages (JPEG quant-prep split)."""
    port = (Port((4, 8, 8), torch.float32),)
    rotate = functools.partial(
        _dct8_rotate, odd_m=torch.as_tensor(_ODD, device=resolve_device(device)))

    def scale1(x):
        return x * 0.5              # row-pass normalization

    def scale2(x):
        return x * 0.5              # column-pass normalization
    fns = [
        _dct8_butterfly1, _dct8_butterfly2, rotate, _transpose88,
        _dct8_butterfly1, _dct8_butterfly2, rotate, _transpose88,
        scale1, scale2,
    ]
    stages = [Stage(name=f"dct_s{i}", sw=f, hw=f, ports=port, tol=1e-4,
                    device=device)
              for i, f in enumerate(fns)]
    return StagedAccelerator("dct", stages)


_DCT_M = np.array([[np.cos(np.pi * (2 * n + 1) * k / 16)
                    for n in range(8)] for k in range(8)], np.float32)


def dct_reference(x):
    """Direct 2-D DCT-II with the same normalization (x 1/4 overall)."""
    M = torch.as_tensor(_DCT_M, device=x.device)
    y = torch.einsum("kn,...nj->...kj", M, x)   # columns (axis -2)
    y = torch.einsum("kn,...jn->...jk", M, y)   # rows
    return y * 0.25
