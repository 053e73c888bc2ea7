"""spark_rapids_tpu_torch's device mesh and mesh all-to-all exchange
(parallel/mesh.py, parallel/collective_exchange.py, the mesh lane of
shuffle/exchange.py) against spark_rapids_tpu's.

The reference runs its lane on eight virtual CPU devices of one host
(tests/conftest.py); the port's twin is an 8-slot CPU mesh of one
single-controller process, so no process is spawned.  Twins of the two
tests of tests/test_collective_exchange.py (each slot's received rows
held against the reference's collective, same rows in the same order),
the six of tests/test_mesh_exchange.py (TPC-H Q3 and Q5 against the
reference's CPU engine: compare_frames' rtol 1e-5 on sums, keys and
order exact), tests/test_watchdog.py:400 test_collective_hang_times_out
and tests/test_movement.py:353
test_collective_edge_recorded_on_mesh_exchange; and the port's own
cases: make_mesh's refusals, slots over two device groups (the copies
between devices, on CPU devices that compare unequal), and the planner
planning hash exchanges at the mesh's size.
"""
import time

import numpy as np
import pandas as pd
import pytest
import torch
from parity import compare_frames

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.parallel import collective_exchange as RX
from spark_rapids_tpu.parallel.mesh import make_mesh as r_make_mesh
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.ops.murmur3 import partition_ids
from spark_rapids_tpu_torch.parallel import collective_exchange as X
from spark_rapids_tpu_torch.parallel.mesh import (Mesh, active_mesh,
                                                  make_mesh)
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu", slots_per_device=8)


@pytest.fixture(scope="module")
def rmesh8():
    import jax
    assert len(jax.devices()) >= 8, "conftest must force 8 cpu devices"
    return r_make_mesh(8)


def two_groups() -> Mesh:
    """Eight CPU slots over two device groups: torch's "cpu" and "cpu:0"
    name one device but compare unequal, so the lane copies between the
    groups as it would between two cards."""
    return Mesh(tuple([torch.device("cpu"), torch.device("cpu", 0)] * 4))


# --- twins of tests/test_collective_exchange.py -------------------------------
def _per_slot_frames(seed: int, n=8, rows=64) -> list:
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 100, rows).astype(np.int64),
             "v": rng.normal(size=rows),
             "s": np.array([f"r{d}_{i}" for i in range(rows)], dtype=object)}
            for d in range(n)]


def _frames(batches) -> list:
    return [b.to_pandas().reset_index(drop=True) for b in batches]


def _same_slots(want: list, got: list) -> None:
    assert len(want) == len(got)
    for d, (w, g) in enumerate(zip(want, got)):
        pd.testing.assert_frame_equal(w, g, check_exact=True,
                                      obj=f"slot {d}")


@pytest.mark.parametrize("mesh_kind", ["one_device", "two_groups"])
def test_all_to_all_hash_exchange(mesh8, rmesh8, mesh_kind):
    """Every row lands on the slot of murmur3(k) pmod 8, rows and (k, s)
    pairs are conserved, and each slot receives the reference's rows in
    the reference's order (the sources' blocks in slot order)."""
    mesh = mesh8 if mesh_kind == "one_device" else two_groups()
    frames = _per_slot_frames(5)
    rbatches = [RBatch.from_numpy(f) for f in frames]
    rschema = rbatches[0].schema
    rcap = rbatches[0].capacity
    rstep = RX.build_all_to_all_exchange(rmesh8, "data", rschema, [0],
                                         rcap * 8)
    rb = [b.with_capacity(rcap * 8) for b in rbatches]
    arrs, rows = RX.stack_batches(rb, rcap * 8)
    o_arrs, o_rows = rstep(arrs, rows)
    want = _frames(RX.unstack_batches(o_arrs, np.asarray(o_rows), rschema))

    batches = [ColumnarBatch.from_numpy(f, device="cpu") for f in frames]
    schema = batches[0].schema
    cap = batches[0].capacity
    step = X.build_all_to_all_exchange(mesh, "data", schema, [0], cap,
                                       out_capacity=cap * 8)
    p_arrs, p_rows = X.stack_batches(batches, cap)
    out = X.unstack_batches(*step(p_arrs, p_rows), schema)
    assert sum(b.num_rows for b in out) == 8 * 64
    for d, b in enumerate(out):
        if b.num_rows:
            pids = partition_ids([b.column("k")], 8)[:b.num_rows]
            assert bool((pids == d).all())
    _same_slots(want, _frames(out))


def test_all_to_all_empty_devices(mesh8, rmesh8):
    """Slots with no rows take part in the exchange: the rows of the
    others all arrive, as in the reference."""
    rschema = RT.Schema.of(("k", RT.INT64),)
    schema = T.Schema.of(("k", T.INT64),)
    rb, pb = [], []
    for d in range(8):
        n = 0 if d % 2 else 16
        vals = np.arange(n, dtype=np.int64) + d * 100
        rb.append(RBatch.from_numpy({"k": vals}, schema=rschema,
                                    capacity=128))
        pb.append(ColumnarBatch.from_numpy({"k": vals}, schema=schema,
                                           capacity=128, device="cpu"))
    rstep = RX.build_all_to_all_exchange(rmesh8, "data", rschema, [0], 128)
    o_arrs, o_rows = rstep(*RX.stack_batches(rb, 128))
    want = _frames(RX.unstack_batches(o_arrs, np.asarray(o_rows), rschema))
    step = X.build_all_to_all_exchange(mesh8, "data", schema, [0], 128)
    out = X.unstack_batches(*step(*X.stack_batches(pb, 128)), schema)
    assert sum(b.num_rows for b in out) == 64
    _same_slots(want, _frames(out))


# --- twins of tests/test_mesh_exchange.py -------------------------------------
def _source(seed: int, n_parts=4, rows=200):
    rng = np.random.default_rng(seed)
    schema = T.Schema.of(("k", T.INT64), ("v", T.FLOAT64), ("s", T.STRING))
    parts = [[ColumnarBatch.from_numpy({
        "k": rng.integers(0, 50, rows).astype(np.int64),
        "v": rng.normal(size=rows),
        "s": np.array([f"p{p}r{i}" for i in range(rows)], dtype=object)},
        schema, device="cpu")] for p in range(n_parts)]
    return LocalBatchSource(parts, schema=schema, device="cpu")


def _partition_frames(ex) -> list:
    return [pd.concat([b.to_pandas() for b in it] or
                      [pd.DataFrame(columns=["k", "v", "s"])],
                      ignore_index=True)
            for it in ex.execute_partitions()]


@pytest.mark.parametrize("mesh_kind", ["one_device", "two_groups"])
def test_exchange_exec_mesh_vs_local_lane(mesh8, mesh_kind):
    """One ShuffleExchangeExec gives the same rows per partition through
    the mesh all-to-all as through the local lane."""
    local = _partition_frames(
        ShuffleExchangeExec(HashPartitioning([col("k")], 8), _source(42)))
    ShuffleExchangeExec._MESH_EXCHANGES_RUN = 0
    with active_mesh(mesh8 if mesh_kind == "one_device" else two_groups()):
        meshed = _partition_frames(ShuffleExchangeExec(
            HashPartitioning([col("k")], 8), _source(42)))
    assert ShuffleExchangeExec._MESH_EXCHANGES_RUN == 1
    assert len(local) == len(meshed) == 8
    for p, (lp, mp) in enumerate(zip(local, meshed)):
        compare_frames(lp, mp, f"part{p}")


def test_mesh_lane_declines_without_mesh():
    ex = ShuffleExchangeExec(HashPartitioning([col("k")], 8), _source(1))
    assert ex._mesh_routable() is None


def test_mesh_lane_declines_on_partition_mismatch(mesh8):
    with active_mesh(mesh8):
        ex = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                                 _source(1))
        assert ex._mesh_routable() is None


def test_mesh_lane_conf_off(mesh8):
    conf = C.RapidsConf({"spark.rapids.shuffle.meshExchange.enabled": False})
    with C.session(conf), active_mesh(mesh8):
        ex = ShuffleExchangeExec(HashPartitioning([col("k")], 8),
                                 _source(1))
        assert ex._mesh_routable() is None


@pytest.fixture(scope="module")
def tpch_tables():
    from spark_rapids_tpu_torch.models.tpch_data import gen_tables
    return gen_tables(np.random.default_rng(7), 3000)


@pytest.mark.parametrize("query", [3, 5])
def test_tpch_mesh_exchange_parity(tpch_tables, mesh8, query):
    """Q3 and Q5 planned by accelerate() with a mesh active: the planner
    plans their hash exchanges at the mesh's size, they run the mesh
    all-to-all, and the result equals the reference's CPU engine on the
    same frames (keys and order exact, sums rtol 1e-5) and the port's
    local lane."""
    from spark_rapids_tpu.models import tpch_bench as RB
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    expected = RB.run_query(query, tpch_tables, engine="cpu")
    conf = C.RapidsConf(dict(TB.BENCH_CONF))
    ShuffleExchangeExec._MESH_EXCHANGES_RUN = 0
    with active_mesh(mesh8):
        plan = accelerate(QUERIES[query](TD.sources(tpch_tables, 2), None),
                          conf, device="cpu")
        got = collect(plan, conf)
    assert ShuffleExchangeExec._MESH_EXCHANGES_RUN > 0, \
        "no exchange took the mesh lane"
    counts = {n.partitioning.num_partitions for n in _walk(plan)
              if isinstance(n, ShuffleExchangeExec)
              and isinstance(n.partitioning, HashPartitioning)}
    assert counts == {8}, counts
    compare_frames(expected, got, f"q{query}-mesh")
    for c in got.columns:
        if not pd.api.types.is_float_dtype(got[c]):
            assert list(got[c]) == list(expected[c]), f"{c}: keys or order"
    local = TB.run_query(query, tpch_tables, device="cpu")
    compare_frames(local, got, f"q{query} local lane")


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_oversized_single_batch_shards_across_mesh(mesh8):
    """One batch past the row cap is cut across the slots before the
    all-to-all, and the exchange stays exact: every row arrives once, on
    the slot of its key's murmur3 partition."""
    from spark_rapids_tpu_torch.plan.nodes import CpuSource
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    rng = np.random.default_rng(33)
    rows = 4000
    df = pd.DataFrame({"k": rng.integers(0, 500, rows).astype(np.int64),
                       "v": rng.uniform(0, 1, rows)})
    schema = CpuSource.from_pandas(df).output_schema()
    big = batch_from_df(df, schema, device="cpu")
    src = LocalBatchSource([[big]], schema, device="cpu")
    conf = C.RapidsConf({"spark.rapids.tpu.batchMaxRows": 512})
    before = ShuffleExchangeExec._OVERSIZED_SPLITS
    with C.session(conf), active_mesh(mesh8):
        ex = ShuffleExchangeExec(HashPartitioning([col("k")], 8), src)
        outs = [list(it) for it in ex.execute_partitions()]
    assert ShuffleExchangeExec._OVERSIZED_SPLITS > before, \
        "oversized batch was not cut"
    got = pd.concat([b.to_pandas() for bs in outs for b in bs],
                    ignore_index=True)
    assert len(got) == rows
    assert int(got["k"].sum()) == int(df["k"].sum())
    compare_frames(df, got, "oversized")
    for p, bs in enumerate(outs):
        for b in bs:
            pids = partition_ids([b.column("k")], 8)[:b.num_rows]
            assert bool((pids == p).all())


# --- the watchdog's and the movement ledger's collective hooks ---------------
def test_collective_hang_times_out(mesh8):
    """Twin of tests/test_watchdog.py:400: a hang injected at the
    collective site is cancelled by the watchdog within twice the
    collective deadline, and nothing is left held."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    from test_torch_watchdog import _no_leaks, _wd
    W.reset_hang_injection()
    W.begin_query()
    rng = np.random.default_rng(3)
    schema = T.Schema.of(("k", T.INT64), ("v", T.FLOAT64))
    parts = [[ColumnarBatch.from_numpy({
        "k": rng.integers(0, 50, 200).astype(np.int64),
        "v": rng.normal(size=200)}, schema, device="cpu")] for _ in range(8)]
    conf = C.RapidsConf(_wd(site="collective", after=0, deadline=1.5))
    t0 = time.monotonic()
    try:
        with pytest.raises(W.TpuQueryTimeout) as ei:
            with C.session(conf), active_mesh(mesh8):
                ex = ShuffleExchangeExec(
                    HashPartitioning([col("k")], 8),
                    LocalBatchSource(parts, schema=schema, device="cpu"))
                sum(b.num_rows for it in ex.execute_partitions()
                    for b in it)
        assert time.monotonic() - t0 < 2 * 1.5 + 8.0
        assert "collective" in str(ei.value)
        _no_leaks()
    finally:
        W.reset_hang_injection()
        W.begin_query()


def test_collective_edge_recorded_on_mesh_exchange(mesh8):
    """Twin of tests/test_movement.py:353: a mesh exchange puts its
    stacked payload on the collective edge (site mesh-exchange; the count
    phase's n x n counts at mesh-count), and the exchange's
    collectiveBytes metric equals the edge's total."""
    from spark_rapids_tpu_torch.utils import metrics as M
    from spark_rapids_tpu_torch.utils import movement as MV
    from spark_rapids_tpu_torch.utils import profile as P
    rng = np.random.default_rng(42)
    schema = T.Schema.of(("k", T.INT64), ("v", T.FLOAT64))
    parts = [[ColumnarBatch.from_numpy({
        "k": rng.integers(0, 50, 200).astype(np.int64),
        "v": rng.normal(size=200)}, schema, device="cpu")] for _ in range(4)]
    owner = P.begin_query(C.RapidsConf(
        {"spark.rapids.sql.profile.enabled": True}))
    assert owner is not None
    try:
        with active_mesh(mesh8):
            ex = ShuffleExchangeExec(
                HashPartitioning([col("k")], 8),
                LocalBatchSource(parts, schema=schema, device="cpu"))
            rows = sum(b.num_rows for it in ex.execute_partitions()
                       for b in it)
        assert rows == 800
        led = owner.ledger
        cbytes = led.edge_bytes(MV.EDGE_COLLECTIVE)
        sites = led.snapshot()["collective"]
        assert "mesh-exchange" in sites and "mesh-count" in sites
        assert sites["mesh-count"]["bytes"] == 8 * 8 * 8
        assert cbytes == sites["mesh-exchange"]["bytes"] + 8 * 8 * 8
        assert ex.metrics.value(M.COLLECTIVE_BYTES) == cbytes
    finally:
        P.end_query(owner)


# --- the port's own: make_mesh, placements -----------------------------------
def test_make_mesh_refuses_more_slots_than_asked_room():
    """Past the visible devices times slots_per_device, make_mesh raises
    (the reference's refusal to oversubscribe); several slots on one
    device only when asked for."""
    with pytest.raises(ValueError, match="exceeds the"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="exceeds the"):
        make_mesh(9, device="cpu", slots_per_device=8)
    m = make_mesh(4, device="cpu", slots_per_device=4)
    assert m.shape == {"data": 4} and m.home == torch.device("cpu")
    assert len(m.groups) == 1 and m.groups[0][1] == (0, 1, 2, 3)
    assert make_mesh(device="cpu").size == 1


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4, slots_per_device=4)


def test_placements_split_and_gather_in_slot_order():
    from spark_rapids_tpu_torch.parallel.mesh import data_sharding, replicated
    mesh = two_groups()
    place = data_sharding(mesh)
    t = torch.arange(8 * 3).view(8, 3)
    chunks = place.put(t)
    assert [c[:, 0].tolist() for c in chunks] == [[0, 6, 12, 18],
                                                   [3, 9, 15, 21]]
    assert torch.equal(place.gather(chunks), t)
    assert all(torch.equal(c, t) for c in replicated(mesh).put(t))
