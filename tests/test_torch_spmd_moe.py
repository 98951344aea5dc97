"""The MoE family through the tensor-parallel serve (``launch/tp_serve.py``)
over (1, 2), with the default fault stage: attention, the MoE models'
one kernel stage (``fault_stage_for``; their FFN is plain products, as
in the reference).

mixtral-8x7b-smoke (top-2, a window on every layer: a ring KV cache) and
llama4-scout-17b-a16e-smoke (top-1 and a shared expert) served in
float32 hold the unsharded engine's logits to 1e-4 at every call before
the fault, and every rank demotes attention at the fault step; in bf16
the ranks agree on tokens (no logit bound there: bf16 rounds the
f32-reduced residual another way, and a near-tied router can flip its
top-k).  On the reference's own mixtral-8x7b-smoke weights
(``params_from_jax``) the sharded float32 prefill logits hold the
reference's forward (``jax.jit(model.prefill)``, as its tests run it) to
1e-4.  One launch of two ranks serves every job.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.convert import params_from_jax
from repro_torch.launch import tp_serve
from repro_torch.viscosity import HW, SW
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
MESH = (1, 2)
REL = 1e-4
FAULT_STEP, FAULT_RANK = 3, 1


def _spec(arch, dtype):
    return tp_serve.TPServeSpec(arch=arch, dtype=dtype, hw_route=HW,
                                fault_step=FAULT_STEP, fault_rank=FAULT_RANK,
                                requests=4, slots=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The jobs' ranks: each arch in f32 (held to its unsharded run) and
    in bf16, then mixtral on the reference's weights (its logits saved);
    and the reference's model and params."""
    tmp = tmp_path_factory.mktemp("moe")
    cfg = dataclasses.replace(ref_get_config("mixtral-8x7b-smoke"),
                              dtype="float32")
    rm = ref_build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    weights = str(tmp / "mixtral_ref.pt")
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                               device="cpu"), weights)
    jobs, refs = [], {}
    for arch in ARCHS:
        path = str(tmp / f"{arch}.pt")
        refs[arch] = tp_serve.reference_run(_spec(arch, "float32"), "cpu",
                                            path=path)
        jobs.append(tp_serve.make_job(_spec(arch, "float32"),
                                      ref_logits=path))
    jobs += [tp_serve.make_job(_spec(arch, "bfloat16")) for arch in ARCHS]
    jobs.append(tp_serve.make_job(_spec("mixtral-8x7b", "float32"),
                                  params=weights, out_dir=str(tmp)))
    res = tp_serve.launch_jobs(jobs, MESH, device="cpu",
                               env=dict(os.environ, OMP_NUM_THREADS="1"))
    return {"f32": dict(zip(ARCHS, res[:2])), "bf16": dict(zip(ARCHS,
                                                             res[2:4])),
            "jax": res[4], "refs": refs, "dir": tmp, "rm": rm, "rp": rp}


def test_the_moe_family_faults_attention():
    for arch in ARCHS:
        assert _spec(arch, "float32").fault_stage == "flash_attention"


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_ranks_hold_the_unsharded_engine(served, arch):
    res, ref = served["f32"][arch], served["refs"][arch]
    assert tp_serve.check_agreement(res) == []
    for r in res:
        before = [rel for rel, c in zip(r["logits_rel"], r["calls"])
                  if c["step"] < FAULT_STEP]
        assert len(before) >= FAULT_STEP and max(before) <= REL, \
            r["logits_rel"]
        assert r["fault_applied_step"] == FAULT_STEP
        assert r["routes"][:FAULT_STEP] == [HW] * FAULT_STEP
        assert set(r["routes"][FAULT_STEP:]) == {SW}
        assert r["backend"] == "gloo" and r["world"] == 2
    assert sorted(res[0]["tokens"]) == sorted(ref["tokens"])
    assert all(len(res[0]["tokens"][k]) == len(ref["tokens"][k])
               for k in ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_ranks_agree(served, arch):
    res = served["bf16"][arch]
    assert tp_serve.check_agreement(res) == []
    assert all(r["fault_applied_step"] == FAULT_STEP for r in res)
    assert sorted(res[0]["tokens"]) == sorted(served["refs"][arch]["tokens"])


def test_sharded_prefill_holds_the_reference_forward(served):
    """The first admitted request's prefill on each rank (the reference's
    weights, sharded over (1, 2)) against ``model.prefill`` of the
    reference on the same prompt, float32."""
    spec = _spec("mixtral-8x7b", "float32")
    cfg = spec.config()
    first = sorted(spec.workload(cfg), key=lambda r: (r.arrival, r.rid))[0]
    prompt = np.asarray(first.prompt, np.int32)[None]
    rm = served["rm"]
    rl, _ = jax.jit(rm.prefill)(served["rp"], {
        "tokens": jnp.asarray(prompt),
        "cache": rm.init_cache(1, spec.max_len)})
    want = np.asarray(rl, np.float32).reshape(-1, cfg.vocab_size)[-1]
    for r in served["jax"]:
        assert r["logit_kinds"][0] == "prefill"
        got = torch.load(served["dir"] / f"logits_{r['rank']}.pt")[0]
        got = got.float().numpy().reshape(-1)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= REL, rel
