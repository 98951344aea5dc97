"""The port's synthetic LM stream against the reference: the same numpy
draws, so both packages train on the same batches, bit for bit."""
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data import stub_frontend_batch as ref_stub
from repro_torch.data import DataConfig, SyntheticLM, stub_frontend_batch


@pytest.mark.parametrize("seed", [1234, 7])
def test_batch_at_bit_equal_to_reference(seed):
    kw = dict(vocab_size=151936, batch=4, seq_len=128, seed=seed)
    ref, port = RefSyntheticLM(RefDataConfig(**kw)), SyntheticLM(
        DataConfig(**kw))
    for step in range(5):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want) == ["targets", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    it = port.iterate(3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  ref.batch_at(3)["tokens"])


def test_device_batch_on_the_cpu():
    d = SyntheticLM(DataConfig(vocab_size=97, batch=2, seq_len=16))
    b = d.device_batch(4, device="cpu")
    host = d.batch_at(4)
    for k in ("tokens", "targets"):
        assert b[k].device.type == "cpu" and b[k].dtype == torch.int32
        np.testing.assert_array_equal(b[k].numpy(), host[k])


@pytest.mark.parametrize("kind", ["vlm", "audio"])
def test_stub_frontend_batch_matches_reference(kind):
    want = ref_stub(None, 2, 8, 3, 16, kind=kind)
    got = stub_frontend_batch(None, 2, 8, 3, 16, kind=kind)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
