"""Wrapper + Viscosity registration for the attention stage.

Port of the reference's ``kernels/flash_attention/ops.py``.  ``attention``
is the stage entry point the models call; the route selects the lowering:
  * HW        -> the Hopper flash kernel on the model's (B, S, H, D)
                 tensors as they are, in bf16 (a float32 model's rounded
                 to it); its plain version, on tensors padded to the
                 tiles, on CPU tensors
  * INTERPRET -> the kernel's blocked algorithm in PyTorch, CPU only
  * SW        -> the chunked online-softmax oracle
On a CUDA tensor the kernel's plan comes from the tuning cache
(``kernel.resolve``).  The plain version and the INTERPRET replica on CPU
tensors keep the reference's default 128 x 128 tiles: Pallas tiles have no
Hopper meaning, so they look nothing up.  The SW oracle's ``kv_chunk`` is
looked up, as in the reference.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.viscosity import lanefault


def _pad_to(x, m, axis):
    s = x.shape[axis]
    if s % m == 0:
        return x, s
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, m - s % m]
    return F.pad(x, pad), s


def _kernel_path(q, k, v, *, causal=True, window=0, softcap=0.0, scale=0.0,
                 q_offset=None, kv_len=None, kv_chunk=0, bq=None, bk=None,
                 interpret=False):
    fault = lanefault.injection("flash_attention")
    if q_offset is not None or kv_len is not None:
        # decode-style calls carry dynamic positions; the kernel targets
        # train/prefill.  As in the reference this branch is the HW
        # lowering for such calls, so an active lane fault corrupts it too.
        out = _ref.attention_chunked(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
        return fault.corrupt_tree(out) if fault is not None else out
    if q.device.type == "cuda" and not interpret:
        # the Hopper kernel reads the model's (B, S, H, D) tensors through
        # their strides and writes a (B, S, H, Dv) output: no copy, no pad.
        # It takes bf16 only: a float32 model's operands are rounded to
        # bf16 for it (a copy) and its output comes back in their dtype
        bf = torch.bfloat16
        return flash_attention_bhsd(
            q.transpose(1, 2).to(bf), k.transpose(1, 2).to(bf),
            v.transpose(1, 2).to(bf), causal=causal, window=window,
            softcap=softcap, scale=scale,
            lane_fault=fault).transpose(1, 2).to(q.dtype)
    Sq, Skv = q.shape[1], k.shape[1]
    bq = min(bq or 128, max(8, Sq))
    bk = min(bk or 128, max(8, Skv))
    qt, _ = _pad_to(q.transpose(1, 2), bq, 2)
    kt, real_kv = _pad_to(k.transpose(1, 2), bk, 2)
    vt, _ = _pad_to(v.transpose(1, 2), bk, 2)
    qt, kt, vt = qt.contiguous(), kt.contiguous(), vt.contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              kv_len=real_kv, bq=bq, bk=bk, lane_fault=fault)
    if interpret:
        if q.device.type != "cpu":
            raise ValueError("the INTERPRET route replays the kernel's "
                             "blocked algorithm on the CPU; got a "
                             f"{q.device} tensor")
        out = _ref.attention_ref_blocked(qt, kt, vt, **kw)
    else:
        out = flash_attention_bhsd(qt, kt, vt, **kw)
    return out[:, :, :Sq].transpose(1, 2)


def _lane_slicer(args, kw, keep):
    # attention output lane j depends only on v[..., j]: slicing v's head
    # dim is exact reduced-width execution.
    q, k, v = args
    return (q, k, v[..., list(keep)]), kw


def _sw_path(q, k, v, *, kv_chunk=None, bq=128, bk=128, interpret=False,
             **kw):
    if not kv_chunk:
        B, Sq, H, D = q.shape
        cfg = tuning.lookup_once("flash_attention", "sw",
                                 (B, Sq, k.shape[1], H, k.shape[2], D),
                                 q.dtype) or {}
        kv_chunk = cfg.get("kv_chunk") or 512
    return _ref.attention_chunked(q, k, v, kv_chunk=kv_chunk, **kw)


ATTENTION = viscosity.defop(
    "flash_attention",
    ref=_sw_path,
    kernel=_kernel_path,
    interpret=functools.partial(_kernel_path, interpret=True),
    valid=viscosity.finite_valid,
    tol=2e-2,
    flops=lambda q, k, *a, **kw: _ref.attention_flops(
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]),
    lane_slicer=_lane_slicer,
)


def attention(q, k, v, *, route: str = viscosity.SW, **kw) -> torch.Tensor:
    return ATTENTION(q, k, v, route=route, **kw)
