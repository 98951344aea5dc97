"""Hillclimb variants: named sharding/structure configurations (the
port's ``launch/variants.py``).

Each variant gives: optional mesh override (shape+axes), activation rules,
param-axis assignment, and config overrides.  ``launch/hillclimb.py`` runs
a cell under a variant and compares roofline terms against the baseline.
The table is the reference's as it stands; knobs the port's step lacks
raise in ``hillclimb.check_knobs``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def _rules_2d(h_ax, f_ax):
    both = (h_ax, f_ax)
    return {
        "batch": ("data",), "seq": None, "embed": None,
        "heads": h_ax, "kv_heads": h_ax, "kv_seq": None, "head_dim": None,
        "mlp": both, "vocab": both,
        "experts": None, "expert_cap": None,
        "ssm_inner": both, "ssm_state": None, "ssm_heads": h_ax,
    }


VARIANTS: Dict[str, Dict[str, Any]] = {
    # HC-A: avoid re-running TP collectives in the backward recompute
    "remat_coll": dict(overrides={"remat_policy": "collectives"}),
    # HC-A: dots-saveable (max compute reuse; memory cost measured)
    "remat_dots": dict(overrides={"remat_policy": "dots"}),
    # HC-C: 2D attention sharding — heads over a 4-way sub-axis (divides
    # qwen's 20 heads), FFN/vocab over the full 16-way product.  Attention
    # replication drops 16x -> 4x.
    "attn2d": dict(mesh_shape=(16, 4, 4),
                   mesh_axes=("data", "model_h", "model_f"),
                   rules=_rules_2d("model_h", "model_f"),
                   axes={"attn": "model_h",
                         "ffn": ("model_h", "model_f"),
                         "vocab": ("model_h", "model_f"),
                         "ssm": ("model_h", "model_f"),
                         "expert": None}),
    # HC-B: expert parallelism — model axis refactored into expert x tp
    "ep": dict(mesh_shape=(16, 8, 2),
               mesh_axes=("data", "expert", "tp"),
               rules={**_rules_2d("expert", "tp"),
                      "heads": ("expert", "tp"), "kv_heads": "expert",
                      "mlp": "tp", "experts": "expert"},
               axes={"attn": ("expert", "tp"), "ffn": "tp",
                     "vocab": ("expert", "tp"), "ssm": "tp",
                     "expert": "expert"}),
    # HC-B: combine expert outputs BEFORE the TP all-reduce
    "moe_combine_first": dict(overrides={}, moe_combine_first=True),
    # bigger attention chunk (fewer scan trips, same score traffic)
    "chunk2k": dict(overrides={"attn_chunk": 2048}),
    # HC-A: accumulate per-microbatch grads UNREDUCED over data axes;
    # the cross-replica all-reduce runs once per step
    "grad_unreduced": dict(train_kw={"grad_unreduced": True}),
    # composite: RS grad accumulation + collectives-saving remat
    "hc_a": dict(train_kw={"grad_unreduced": True},
                 overrides={"remat_policy": "collectives"}),
    # composite + bigger microbatch (memory headroom from neither saving
    # activations twice nor replicating grads)
    "hc_a_mb8": dict(train_kw={"grad_unreduced": True},
                     overrides={"remat_policy": "collectives"},
                     microbatch=8),
    "hc_a_mb4": dict(train_kw={"grad_unreduced": True},
                     overrides={"remat_policy": "collectives"},
                     microbatch=4),
    # HC-B composite: EP mesh + combine-first + RS grads + remat_coll
    "hc_b": dict(mesh_shape=(16, 8, 2),
                 mesh_axes=("data", "expert", "tp"),
                 rules={**_rules_2d("expert", "tp"),
                        "heads": ("expert", "tp"), "kv_heads": "expert",
                        "mlp": "tp", "experts": "expert"},
                 axes={"attn": ("expert", "tp"), "ffn": "tp",
                       "vocab": ("expert", "tp"), "ssm": "tp",
                       "expert": "expert"},
                 train_kw={"grad_unreduced": True},
                 overrides={"remat_policy": "collectives"},
                 moe_combine_first=True,
                 microbatch=8),
    # HC-B v2: EP + RS grads + remat_coll, WITHOUT combine_first
    "hc_b2": dict(mesh_shape=(16, 8, 2),
                  mesh_axes=("data", "expert", "tp"),
                  rules={**_rules_2d("expert", "tp"),
                         "heads": ("expert", "tp"), "kv_heads": "expert",
                         "mlp": "tp", "experts": "expert"},
                  axes={"attn": ("expert", "tp"), "ffn": "tp",
                        "vocab": ("expert", "tp"), "ssm": "tp",
                        "expert": "expert"},
                  train_kw={"grad_unreduced": True},
                  overrides={"remat_policy": "collectives"},
                  microbatch=8),
    "hc_b3": dict(mesh_shape=(16, 8, 2),
                  mesh_axes=("data", "expert", "tp"),
                  rules={**_rules_2d("expert", "tp"),
                         "heads": ("expert", "tp"), "kv_heads": "expert",
                         "mlp": "tp", "experts": "expert"},
                  axes={"attn": ("expert", "tp"), "ffn": "tp",
                        "vocab": ("expert", "tp"), "ssm": "tp",
                        "expert": "expert"},
                  train_kw={"grad_unreduced": True},
                  overrides={"remat_policy": "collectives"},
                  microbatch=16),
    # HC-B final: EP + ZeRO-1 sharded optimizer + RS grads + remat_coll
    "hc_b_zero1": dict(mesh_shape=(16, 8, 2),
                       mesh_axes=("data", "expert", "tp"),
                       rules={**_rules_2d("expert", "tp"),
                              "heads": ("expert", "tp"),
                              "kv_heads": "expert",
                              "mlp": "tp", "experts": "expert"},
                       axes={"attn": ("expert", "tp"), "ffn": "tp",
                             "vocab": ("expert", "tp"), "ssm": "tp",
                             "expert": "expert"},
                       train_kw={"zero1": True},
                       overrides={"remat_policy": "collectives"},
                       microbatch=16),
    # ZeRO-1 alone on the production mesh (applies to every train cell)
    "zero1": dict(train_kw={"zero1": True}),
    "hc_a_zero1": dict(train_kw={"zero1": True},
                       overrides={"remat_policy": "collectives"},
                       microbatch=8),
    # HC-B final+: bf16 params (f32 moments = master copy) + EP + ZeRO-1
    "hc_b_final": dict(mesh_shape=(16, 8, 2),
                       mesh_axes=("data", "expert", "tp"),
                       rules={**_rules_2d("expert", "tp"),
                              "heads": ("expert", "tp"),
                              "kv_heads": "expert",
                              "mlp": "tp", "experts": "expert"},
                       axes={"attn": ("expert", "tp"), "ffn": "tp",
                             "vocab": ("expert", "tp"), "ssm": "tp",
                             "expert": "expert"},
                       train_kw={"zero1": True},
                       overrides={"remat_policy": "collectives",
                                  "param_dtype": "bfloat16"},
                       microbatch=16),
}


def variant_mesh(v: Dict[str, Any], multi_pod: bool, devices=None):
    """The variant's mesh (the production mesh without an override);
    ``devices`` as ``launch.mesh.make_mesh`` takes them (the dry run
    passes ``torch.device("meta")`` ones)."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if "mesh_shape" not in v:
        n = 512 if multi_pod else 256
        return make_production_mesh(
            multi_pod=multi_pod,
            devices=devices or [torch.device("meta")] * n)
    shape, axes = v["mesh_shape"], v["mesh_axes"]
    if multi_pod:
        shape = (2,) + tuple(shape)
        axes = ("pod",) + tuple(axes)
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes,
                     devices=devices or [torch.device("meta")] * n)
