"""spark_rapids_tpu_torch/graft_entry.py against the repository's
`__graft_entry__.py`: the twin of tests/test_graft_entry.py:153
test_dryrun_multichip_in_suite (the distributed step over an 8-slot CPU
mesh of one process, figures equal to the reference's over its eight
virtual CPU devices) and entry()'s Q1 step against the reference's on
the same batch.  The reference file's other four tests route the
reference between JAX backends and processes; a torch mesh has no such
routing, so they have no twin.
"""
import re

import numpy as np
import pytest

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import graft_entry as G
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def test_dryrun_multichip_in_suite(capsys):
    import jax
    import __graft_entry__ as g
    assert len(jax.devices("cpu")) >= 8
    g.dryrun_multichip(8)
    ref = capsys.readouterr().out
    m = re.search(r"exchanged (\d+) rows .* lane (\d+) groups OK", ref)
    assert m, ref
    got = G.dryrun_multichip(8, device="cpu")
    assert (got["rows"], got["groups"]) == (int(m.group(1)),
                                            int(m.group(2)))
    assert got["slots"] == 8 and got["devices"] == 1
    # one grouped_sum call a slot (its plain twin on CPU tensors)
    assert got["grouped_sum_launches"] == 0
    assert "8-slot mesh" in capsys.readouterr().out


@pytest.mark.parametrize("q1_conf", [False, True])
def test_entry_matches_reference(q1_conf):
    """entry()'s step over the same 2,048 drawn rows as the reference's:
    the same arguments, group keys and counts exact, sums rtol 1e-5;
    plain torch ops, or the q1_fused wrapper under
    spark.rapids.tpu.pallas.q1.enabled."""
    import jax
    import __graft_entry__ as g
    r_fn, r_args = g.entry()
    want = jax.jit(r_fn)(*r_args)
    with C.session(C.RapidsConf(
            {"spark.rapids.tpu.pallas.q1.enabled": q1_conf})):
        fn, args = G.entry(device="cpu")
        got = fn(*args)
    for a, ra in zip(args, r_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    assert len(got) == len(want) == 8
    for i in (0, 1, 7):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in range(2, 7):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5)


def test_cuda_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.entry()
