"""The port's closure, train and coordinator campaigns on the CPU,
against the reference (the serve campaign and the schedule:
``test_torch_chaos.py``).

Each against one run of the reference's counterpart: ``closure_scenario``
on converted weights equal key for key; ``train_campaign`` equal in every
key but the wall-clock MTTR (each folds the mean step time); the
coordinator drills' wall-clock MTTR held to their budget.
"""
import jax
import numpy as np
import pytest

from repro.chaos import campaign as ref_campaign
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.obs import metrics as ref_metrics

from repro_torch.chaos.campaign import (closure_scenario,
                                        coordinator_campaign, train_campaign)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401

#: seed 1's smoke training schedule: a device loss, then a host loss
SEED = 1


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config("qwen1.5-4b").reduced()
    jparams = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return rcfg, jparams, get_config("qwen1.5-4b-smoke"), \
        params_from_jax(np_params, device="cpu")


def test_closure_scenario_matches_reference(setup):
    rcfg, jparams, cfg, tparams = setup
    got = closure_scenario(0, n_requests=24, params=tparams, cfg=cfg,
                           device="cpu")
    with ref_metrics.use(ref_metrics.Registry()):
        want = ref_campaign.closure_scenario(0, n_requests=24,
                                             params=jparams, cfg=rcfg)
    assert got == want
    assert got["ok"] and got["rel_err"] <= 0.15 and not got["dropped"]


def test_train_campaign_matches_reference(tmp_path):
    got = train_campaign(SEED, n_events=2, ckpt_dir=str(tmp_path / "port"),
                         device="cpu")
    with ref_metrics.use(ref_metrics.Registry()):
        want = ref_campaign.train_campaign(SEED, n_events=2,
                                           ckpt_dir=str(tmp_path / "ref"))
    assert got["invariants"]["ok"], got["invariants"]["reports"]
    assert [e["kind"] for e in got["schedule"]] == \
        ["device_loss", "host_loss"]
    assert "checkpoint_restored" in [r["invariant"] for r in
                                     got["invariants"]["reports"]]
    for res in (got, want):          # mean step wall time folds into each
        for m in res["mttr"]:
            m.pop("mttr_s")
        res.pop("mttr_summary")
    assert got == want


def test_coordinator_campaign_fast_typed_mttr():
    r = coordinator_campaign(2)
    assert r["invariants"]["ok"], r["invariants"]["reports"]
    assert r["n_events"] == 2 and r["mttr_summary"]["n"] == 2
    assert r["mttr_summary"]["max_s"] < 5.0
