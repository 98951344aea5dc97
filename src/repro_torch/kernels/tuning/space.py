"""Search spaces + admissibility for the Hopper kernels' launch knobs.

Port of the reference's ``kernels/tuning/space.py``.  The reference's
knobs are Pallas tiles sized for a TPU; the Hopper kernels take none of
them.  Their knobs are the ones the CUDA launchers take at run time:

  * ``flash_attention`` (hw): ``nwg`` consumer warpgroups a block (64
    query rows each), ``stages`` K/V stages in the ring, ``per_sm`` blocks
    a SM the persistent grid is sized for;
  * ``swiglu_mlp`` (hw): ``nwg`` consumer warpgroups a block, ``nsub``
    64-column w2 tiles a phase-B block.  The slice count and the K tiling
    are not knobs: they set each row's f32 summation order and depend on
    the widths only (``kernels/swiglu/kernel.py::split_count``);
  * ``mamba2_ssd`` / ``rwkv6_wkv`` (hw and sw): the chunk length;
  * ``flash_attention`` (sw): the chunked oracle's ``kv_chunk``.

None of these changes a row's arithmetic in attention or SwiGLU; the scans'
chunk changes their f32 rounding within the plain version's tolerance.
The admissibility predicate is the card's, and the wrappers own it: an
attention or SwiGLU config is admissible where the wrapper's ``plan``
takes it (``plan`` holds the knobs to the shared-memory limits and
compiled instantiations the wrapper defines: ``SMEM_LIMIT``, ``SMEM_SM``,
``MAX_STAGES``, ``COMPILED_WIDE``), and a scan's chunk where it is at most
the kernel's ``LMAX``; the wrappers are imported at call time (they
import this package).  So no space admits a config the wrapper or the
CUDA launcher refuses.  On Hopper a kernel's default depends on the
shape, so ``defaults(shape)`` is the plan each wrapper picks today.

The WKV's chunk stops at ``LMAX = 16`` in both kinds: its factorization
takes exp(-la) with |la| up to 4 L at the model's clamp lw >= -4, inside
f32 only for L <= 16 (the reference's own spaces admit 32-128, where its
chunked oracle returns non-finite output).

Shapes are the reference's canonical tuples (what ``tuning.lookup`` keys
on):

  flash_attention  (B, Sq, Skv, H, Hkv, D)     Dv = D
  swiglu_mlp       (M, D, F)                   Do = D
  mamba2_ssd       (B, S, H, P, N)
  rwkv6_wkv        (B, S, H, K, V)
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

# Lowering kinds a space is declared for (the viscosity HW/SW names).
HW = "hw"
SW = "sw"


@dataclass(frozen=True)
class KernelSpace:
    """The tunable knobs of one (kernel, lowering-kind) pair.

    ``params`` maps knob name -> ordered candidate values (ascending, so
    the hillclimber's neighbor move is "one index up/down").
    ``check(cfg, shape)`` is the hard constraint; ``defaults(shape)`` the
    config the kernel runs with no tuning entry.
    """

    kernel: str
    kind: str
    params: Mapping[str, Tuple[int, ...]]
    check: Optional[Callable[[Dict[str, int], Tuple[int, ...]], bool]] = None
    defaults: Optional[Callable[[Tuple[int, ...]], Dict[str, int]]] = None

    def admissible(self, cfg: Mapping[str, int],
                   shape: Tuple[int, ...]) -> bool:
        """Is ``cfg`` one the kernel will accept for ``shape``?"""
        if set(cfg) != set(self.params):
            return False
        for name, choices in self.params.items():
            if cfg[name] not in choices:
                return False
        return self.check is None or bool(self.check(dict(cfg),
                                                     tuple(shape)))

    def default(self, shape: Tuple[int, ...]) -> Dict[str, int]:
        return dict(self.defaults(tuple(shape))) if self.defaults else {}

    def configs(self, shape: Tuple[int, ...]):
        """All admissible configs for ``shape`` (the sweep grid)."""
        names = sorted(self.params)
        for vals in itertools.product(*(self.params[n] for n in names)):
            cfg = dict(zip(names, vals))
            if self.admissible(cfg, shape):
                yield cfg

    def neighbors(self, cfg: Mapping[str, int], shape: Tuple[int, ...]):
        """Admissible one-step moves (one knob, one choice index up/down)
        — the hillclimber's proposal set."""
        for name in sorted(self.params):
            choices = self.params[name]
            i = choices.index(cfg[name])
            for j in (i - 1, i + 1):
                if 0 <= j < len(choices):
                    cand = dict(cfg)
                    cand[name] = choices[j]
                    if self.admissible(cand, shape):
                        yield cand


def _takes(plan, *args, **knobs) -> bool:
    """Whether the wrapper's ``plan`` takes these knobs at this shape."""
    try:
        plan(*args, **knobs)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------ flash attn
def _attention():
    from repro_torch.kernels.flash_attention import kernel
    return kernel


def _flash_hw_check(cfg, shape):
    """``plan``'s rules (Dv = D): two warpgroups only up to 128 head dims
    (two boxes); two blocks a SM only with one warpgroup; the ring of
    ``stages`` stages within the block's budget, half an SM less 1 KB at
    two blocks a SM."""
    B, Sq, Skv, H, Hkv, D = shape
    return _takes(_attention().plan, B, H, Hkv, Sq, Skv, D, D, **cfg)


def _flash_hw_defaults(shape):
    B, Sq, Skv, H, Hkv, D = shape
    return _attention().plan(B, H, Hkv, Sq, Skv, D, D).knobs()


def _flash_sw_check(cfg, shape):
    _B, _Sq, Skv, _H, _Hkv, _D = shape
    # attention_chunked clamps to min(kv_chunk, Skv) and pads: any positive
    # chunk runs, but chunks beyond Skv are equivalent to Skv.
    return 0 < cfg["kv_chunk"] <= max(128, 2 * Skv)


# ---------------------------------------------------------------- swiglu
def _swiglu():
    from repro_torch.kernels.swiglu import kernel
    return kernel


def _swiglu_hw_check(cfg, shape):
    """``plan``'s rules (Do = D): 128 columns a phase-B block only with two
    or three warpgroups and a padded output width of whole 128s."""
    M, D, F = shape
    return _takes(_swiglu().plan, M, D, F, D, **cfg)


def _swiglu_hw_defaults(shape):
    M, D, F = shape
    return _swiglu().plan(M, D, F, D).knobs()


# ------------------------------------------------------------ scan chunks
def _chunk_check(cfg, shape):
    S = shape[1]
    return 0 < cfg["chunk"] <= max(16, S)


def _ssd_hw_check(cfg, shape):
    from repro_torch.kernels.mamba2_scan import kernel
    return cfg["chunk"] <= kernel.LMAX and _chunk_check(cfg, shape)


def _wkv_check(cfg, shape):
    from repro_torch.kernels.rwkv6_scan import kernel
    return cfg["chunk"] <= kernel.LMAX and _chunk_check(cfg, shape)


def _const(**cfg):
    return lambda shape: dict(cfg)


SPACES: Dict[Tuple[str, str], KernelSpace] = {}


def _declare(space: KernelSpace) -> KernelSpace:
    SPACES[(space.kernel, space.kind)] = space
    return space


_declare(KernelSpace(
    kernel="flash_attention", kind=HW,
    params={"nwg": (1, 2), "stages": (2, 3, 4), "per_sm": (1, 2)},
    check=_flash_hw_check, defaults=_flash_hw_defaults,
))
_declare(KernelSpace(
    kernel="flash_attention", kind=SW,
    params={"kv_chunk": (64, 128, 256, 512, 1024, 2048)},
    check=_flash_sw_check, defaults=_const(kv_chunk=512),
))
_declare(KernelSpace(
    kernel="swiglu_mlp", kind=HW,
    params={"nwg": (1, 2, 3), "nsub": (1, 2)},
    check=_swiglu_hw_check, defaults=_swiglu_hw_defaults,
))
_declare(KernelSpace(
    kernel="mamba2_ssd", kind=HW,
    params={"chunk": (16, 32, 64, 128)},
    check=_ssd_hw_check, defaults=_const(chunk=128),
))
_declare(KernelSpace(
    kernel="mamba2_ssd", kind=SW,
    params={"chunk": (16, 32, 64, 128, 256)},
    check=_chunk_check, defaults=_const(chunk=128),
))
_declare(KernelSpace(
    kernel="rwkv6_wkv", kind=HW,
    params={"chunk": (8, 16)},
    check=_wkv_check, defaults=_const(chunk=16),
))
_declare(KernelSpace(
    kernel="rwkv6_wkv", kind=SW,
    params={"chunk": (8, 16)},
    check=_wkv_check, defaults=_const(chunk=16),
))


def space_for(kernel: str, kind: str) -> Optional[KernelSpace]:
    return SPACES.get((kernel, kind))


def admissible(kernel: str, kind: str, cfg: Mapping[str, int],
               shape: Sequence[int]) -> bool:
    """Module-level predicate (what the property tests call)."""
    space = space_for(kernel, kind)
    return space is not None and space.admissible(cfg, tuple(shape))
