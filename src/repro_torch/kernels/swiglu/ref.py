"""PyTorch oracle for the fused gated MLP (SwiGLU / GeGLU) stage.

Port of the reference's ``kernels/swiglu/ref.py``:
y = act(x @ w1) * (x @ w3) @ w2 ;  x (M, D), w1/w3 (D, F), w2 (F, Do).
"""
from __future__ import annotations

import torch

from repro_torch.viscosity.lanefault import apply_fault


def _act(h, act: str):
    if act == "silu":
        return torch.nn.functional.silu(h)
    if act == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    raise ValueError(act)


def gate(h1, act: str):
    """The kernel's exact activation arithmetic."""
    if act == "silu":
        return h1 * torch.sigmoid(h1)
    if act == "gelu":  # tanh-approx gelu, the kernel's formula
        return 0.5 * h1 * (1.0 + torch.tanh(0.7978845608028654 *
                                            (h1 + 0.044715 * h1 * h1 * h1)))
    raise ValueError(act)


def swiglu_ref(x, w1, w3, w2, *, act: str = "silu",
               row_independent: bool = False):
    """The SW oracle.  ``row_independent=True`` computes each row as its
    own (1, D) product, so a row's result does not depend on how many
    rows share the call (batched decode must match single-request decode
    bit for bit; a batched GEMM may pick another summation order)."""
    if row_independent and x.shape[0] > 1:
        return torch.cat([swiglu_ref(x[i:i + 1], w1, w3, w2, act=act)
                          for i in range(x.shape[0])])
    xf = x.float()
    h = _act(xf @ w1.float(), act) * (xf @ w3.float())
    return (h @ w2.float()).to(x.dtype)


def swiglu_ref_blocked(x, w1, w3, w2, *, act: str = "silu", bm: int = 128,
                       bf: int = 512, bs: int = 128, lane_fault=None):
    """PyTorch replica of the kernel's blocked algorithm: the same tiles,
    dot shapes and f32 accumulation order as the reference's
    ``swiglu_pallas``, the fault point at the flush; the output width is
    ``w2.shape[1]``.  The plain version of ``kernel.swiglu_fused``."""
    M, D = x.shape
    F = w1.shape[1]
    Do = w2.shape[1]
    bm, bf = min(bm, M), min(bf, F)
    bs = min(bs, bf)
    if M % bm or F % bf or bf % bs:
        raise ValueError(f"blocked swiglu needs M % bm == F % bf == "
                         f"bf % bs == 0; got {(M, bm, F, bf, bs)}")
    rows = []
    for mi in range(M // bm):
        xb = x[mi * bm:(mi + 1) * bm].float()
        acc = torch.zeros((bm, Do), dtype=torch.float32, device=x.device)
        for lo in range(0, F, bs):
            h1 = xb @ w1[:, lo:lo + bs].float()
            h3 = xb @ w3[:, lo:lo + bs].float()
            acc = acc + (gate(h1, act) * h3) @ w2[lo:lo + bs].float()
        rows.append(apply_fault(acc, lane_fault).to(x.dtype))
    return torch.cat(rows, dim=0)


def swiglu_flops(M, D, F) -> int:
    return int(6 * M * D * F)
