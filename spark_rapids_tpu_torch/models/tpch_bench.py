"""TPC-H at scale factor 10 on one card, and the query runner
(port of spark_rapids_tpu/models/tpch_bench.py `run_query`).

`run_query(n, tables)` runs TPC-H query n through the planner:
`collect(accelerate(QUERIES[n](sources(tables), run), conf), conf)`.

SF10 lineitem is 59,986,052 rows (TPC-H spec 4.2.5).  Two layouts of it
are made here from one seed:
  - `sf10_lineitem`: the seven Q1 columns, dictionary-coded, from
    `tpch.gen_lineitem_arrays`, in 8 batches of at most 7,498,257 rows
    at capacity 2^23, which keeps the dictionary lane open (capacity <
    2^24); the stacked Q1 step takes them back to back as capacity 2^26
    with batch_rows 2^23;
  - `sf10_lineitem_frame`: all 16 lineitem columns with
    `tpch_data.SCHEMAS` types, for the planner's Q1 and Q6.
`sf10_tables` makes the eight tables the other twenty queries read,
linked by dbgen's keys.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.models import tpch, tpch_data

SF10_ROWS = 59_986_052
N_BATCHES = 8
BATCH_CAP = 1 << 23

#: how the reference runs its TPC suites (spark_rapids_tpu's
#: models/tpch_bench.py): order-sensitive float aggregation allowed
BENCH_CONF = {
    "spark.rapids.sql.variableFloatAgg.enabled": True,
    "spark.rapids.sql.incompatibleOps.enabled": True,
}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sf10_lineitem(seed: int, device) -> tuple[list, list, list]:
    """(rows per batch, numpy columns per batch, ColumnarBatch per batch
    on `device`) of SF10 lineitem from `seed`."""
    rng = np.random.default_rng(seed)
    per = -(-SF10_ROWS // N_BATCHES)
    sizes = [min(per, SF10_ROWS - i * per) for i in range(N_BATCHES)]
    arrays = [tpch.gen_lineitem_arrays(rng, n) for n in sizes]
    batches = [ColumnarBatch.from_numpy(a, tpch.LINEITEM_SCHEMA,
                                        capacity=BATCH_CAP, device=device)
               for a in arrays]
    return sizes, arrays, batches


def stacked_columns(batches, sizes, device) -> tuple[list, torch.Tensor]:
    """The batches' seven Q1 columns laid back to back (capacity
    N_BATCHES * BATCH_CAP) in LINEITEM_SCHEMA order, and the per-batch
    int32 row counts: the inputs of the stacked Q1 step."""
    stacked = [torch.cat([b.column(n).data for b in batches])
               for n in tpch.LINEITEM_SCHEMA.names]
    return stacked, torch.tensor(sizes, dtype=torch.int32, device=device)


def run_query(n: int, tables, device="cuda",
              conf: Optional[C.RapidsConf] = None, num_partitions: int = 2):
    """TPC-H query n over `tables` (name -> DataFrame) through the
    planner, on `device` (device="cuda" without a card raises), under
    BENCH_CONF unless `conf` is given."""
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = conf or C.RapidsConf(dict(BENCH_CONF))

    def run(plan):
        return collect(accelerate(plan, conf, device), conf)
    return run(QUERIES[n](tpch_data.sources(tables, num_partitions), run))


#: planner partitions of SF10 lineitem: 3,749,129 rows at most, so each
#: fits capacity 2^22 and the banded lane (BANDED_MAX_CAP = 2^22) opens
SF10_PARTITIONS = 16
#: dbgen's CURRENTDATE (TPC-H spec 4.2.3): it decides the return flag
#: and the line status
_CURRENT_DATE = tpch_data.days("1995-06-17")


def _categorical(options, codes) -> pd.Categorical:
    return pd.Categorical.from_codes(codes, categories=list(options))


#: the word pool of `tpch_data._comment`: names, addresses and comments
#: the queries never read pick from it, so they upload as few categories
_POOL = [f"{a} {b} requests" for a in tpch_data.COLORS
         for b in tpch_data.COLORS]


def _pick_pool(rng, pool: list, n: int) -> pd.Categorical:
    return _categorical(pool, rng.integers(0, len(pool), n))


def _pooled(rng, n: int) -> pd.Categorical:
    return _pick_pool(rng, _POOL, n)


def _lineitem(rng, odate: np.ndarray, keys
              ) -> tuple[pd.DataFrame, dict]:
    """(frame, numpy columns) of lineitem rows whose orders were placed
    on `odate` and whose l_orderkey, l_partkey, l_suppkey and
    l_linenumber are the dict `keys(rng)`: dates, quantities, prices and
    flags in dbgen's ranges and rules (TPC-H spec 4.2.3), the flags held
    as codes in the numpy columns (returnflag A/N/R = 0/1/2, linestatus
    F/O = 0/1).  `keys` is called after the dates, quantities, prices
    and flags are drawn and before the discounts."""
    rows = len(odate)
    ship = odate + rng.integers(1, 122, rows).astype(np.int32)
    commit = odate + rng.integers(30, 91, rows).astype(np.int32)
    receipt = ship + rng.integers(1, 31, rows).astype(np.int32)
    qty = rng.integers(1, 51, rows).astype(np.float64)
    price = np.round(qty * rng.uniform(900.0, 2099.0, rows), 2)
    late = receipt > _CURRENT_DATE
    flag = np.where(late, 1, np.where(rng.random(rows) < 0.5, 0, 2)
                    ).astype(np.int8)
    status = (ship > _CURRENT_DATE).astype(np.int8)
    arrays = {
        **keys(rng),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": rng.integers(0, 11, rows) / 100.0,
        "l_tax": rng.integers(0, 9, rows) / 100.0,
        "l_returnflag": flag,
        "l_linestatus": status,
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
    }
    frame = pd.DataFrame({
        **{k: v for k, v in arrays.items()
           if k not in ("l_returnflag", "l_linestatus")},
        "l_returnflag": _categorical("ANR", flag),
        "l_linestatus": _categorical("FO", status),
        "l_shipinstruct": _categorical(
            tpch_data.INSTRUCTIONS,
            rng.integers(0, len(tpch_data.INSTRUCTIONS), rows)),
        "l_shipmode": _categorical(
            tpch_data.SHIP_MODES,
            rng.integers(0, len(tpch_data.SHIP_MODES), rows)),
        "l_comment": _pooled(rng, rows),
    })[list(tpch_data.SCHEMAS["lineitem"].names)]
    return frame, arrays


def sf10_lineitem_frame(seed: int, rows: int = SF10_ROWS
                        ) -> tuple[pd.DataFrame, dict]:
    """(frame, numpy columns) of lineitem alone in dbgen's value ranges
    (TPC-H spec 4.2.3), drawn vectorized from `seed`: all 16 columns
    with `tpch_data.SCHEMAS` types.  Money columns are float64 rounded
    to cents and dates DATE32 days.  String columns are pandas
    Categoricals (dictionary-coded on the host, uploaded as bytes): the
    flags follow dbgen's rules from the dates, ship instruct and mode
    are uniform over their lists, and l_comment picks from
    `tpch_data._comment`'s word pool.  The keys link to no other table
    (see `sf10_tables`)."""
    rng = np.random.default_rng(seed)
    odate = rng.integers(tpch_data.days("1992-01-01"),
                         tpch_data.days("1998-08-02") + 1,
                         rows).astype(np.int32)
    return _lineitem(rng, odate, lambda rng: {
        "l_orderkey": rng.integers(1, 60_000_001, rows, dtype=np.int64),
        "l_partkey": rng.integers(1, 2_000_001, rows, dtype=np.int64),
        "l_suppkey": rng.integers(1, 100_001, rows, dtype=np.int64),
        "l_linenumber": rng.integers(1, 8, rows).astype(np.int32),
    })


def _phones(rng, nationkey: np.ndarray) -> pd.Categorical:
    """dbgen's phone layout, country code = nation key + 10, the local
    part from a pool of 1,000 numbers."""
    local = [f"{a}-{b}-{c}" for a, b, c in zip(
        rng.integers(100, 1000, 1000), rng.integers(100, 1000, 1000),
        rng.integers(1000, 10000, 1000))]
    pool = [f"{cc}-{p}" for cc in range(10, 35) for p in local]
    codes = nationkey * len(local) + rng.integers(0, len(local),
                                                  len(nationkey))
    return _categorical(pool, codes)


#: dbgen's 64-character alphabet of random v-strings (addresses)
_ALNUM = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz"
                       b"ABCDEFGHIJKLMNOPQRSTUVWXYZ,.", np.uint8)
#: distinct strings in each pool of `_vstrings` and `_texts`
_POOL_SIZE = 4096


def _vstrings(rng, lo: int, hi: int) -> list:
    """A pool of dbgen's random v-strings (spec 4.2.2.7): lengths
    uniform in [lo, hi], characters from `_ALNUM`."""
    chars = _ALNUM[rng.integers(0, len(_ALNUM), (_POOL_SIZE, hi))]
    lens = rng.integers(lo, hi + 1, _POOL_SIZE)
    return [r[:k].tobytes().decode() for r, k in zip(chars, lens)]


def _texts(rng, lo: int, hi: int) -> list:
    """A pool of comment texts of lengths uniform in [lo, hi]: words of
    `tpch_data.COLORS`, cut to the drawn length."""
    words = np.array(tpch_data.COLORS, dtype=object)[
        rng.integers(0, len(tpch_data.COLORS), (_POOL_SIZE, hi // 3))]
    lens = rng.integers(lo, hi + 1, _POOL_SIZE)
    return [" ".join(w)[:k] for w, k in zip(words, lens)]


def _insert_phrases(rng, texts: list, phrases: list) -> list:
    """`texts` with phrase i of `phrases` inserted into text i at a
    random point, cut back to the text's own length (or the phrase's,
    if longer) so the phrase stays whole."""
    out = []
    for text, phrase in zip(texts, phrases):
        k = int(rng.integers(0, max(len(text) - len(phrase), 0) + 1))
        out.append((text[:k] + phrase + text[k:])[:max(len(text),
                                                      len(phrase))])
    return out


def _words(rng, n: int) -> list:
    return [str(w) for w in np.array(tpch_data.COLORS)[
        rng.integers(0, len(tpch_data.COLORS), n)]]


#: orders whose o_comment matches Q13's '%special%requests%': 41 of the
#: 4,096 pool strings (1.0%); another 41 hold the two words the other
#: way round, which the pattern must not match
O_SPECIAL_POOL = 41


def _order_comments(rng, n_orders: int) -> tuple[pd.Categorical, np.ndarray]:
    """o_comment, texts of 19-78 characters from a pool of 4,096, and the
    mask of the orders whose comment holds "special" before
    "requests"."""
    pool = _texts(rng, 19, 78)
    k = O_SPECIAL_POOL
    pool[:k] = _insert_phrases(rng, pool[:k], [
        f"special {w} requests" for w in _words(rng, k)])
    pool[k:2 * k] = _insert_phrases(rng, pool[k:2 * k], [
        f"requests {w} special" for w in _words(rng, k)])
    codes = rng.integers(0, len(pool), n_orders)
    # short texts of the same words may repeat: categories are distinct
    uniq, first, inv = np.unique(np.array(pool, dtype=object),
                                 return_index=True, return_inverse=True)
    return (_categorical(uniq, inv[codes]),
            first[inv[codes]] < k)


def _supplier_strings(rng, n_supp: int) -> tuple[dict, np.ndarray]:
    """s_name `Supplier#%09d`, s_address a 10-40 character v-string and
    s_comment a 25-100 character text, into which dbgen's rule (TPC-H
    spec 4.2.3) inserts "Customer ... Complaints" for 5 suppliers of
    every 10,000 and "Customer ... Recommends" for 5 others (at least one
    of each at small scales); and the mask of the complaints."""
    keys = np.arange(1, n_supp + 1)
    comments = np.array(_texts(rng, 25, 100), dtype=object)[
        rng.integers(0, _POOL_SIZE, n_supp)]
    k = max(1, round(5 * n_supp / 10_000))
    rows = rng.choice(n_supp, 2 * k, replace=False)
    words = _words(rng, 2 * k)
    comments[rows] = _insert_phrases(rng, list(comments[rows]), [
        f"Customer {w} {'Complaints' if i < k else 'Recommends'}"
        for i, w in enumerate(words)])
    complaint = np.zeros(n_supp, bool)
    complaint[rows[:k]] = True
    return {
        "s_name": np.char.add("Supplier#", np.char.zfill(
            keys.astype("U9"), 9)).astype(object),
        "s_address": _pick_pool(rng, _vstrings(rng, 10, 40), n_supp),
        "s_comment": pd.Categorical(comments),
    }, complaint


def _distinct_words(rng, n: int, k: int) -> np.ndarray:
    """int8[n, k]: k distinct indices into `tpch_data.COLORS` per row, a
    partial Fisher-Yates shuffle done for all rows at once."""
    perm = np.tile(np.arange(len(tpch_data.COLORS), dtype=np.int8), (n, 1))
    rows = np.arange(n)
    for i in range(k):
        j = rng.integers(i, len(tpch_data.COLORS), n)
        head = perm[rows, i].copy()
        perm[rows, i] = perm[rows, j]
        perm[rows, j] = head
    return perm[:, :k]


def part_suppkey(partkey: np.ndarray, i, n_supp: int) -> np.ndarray:
    """dbgen's PART_SUPP_BRIDGE: the part's supplier number i (0..3)."""
    return (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)
            ) % n_supp + 1


def _part_partsupp(rng, n_part: int, n_supp: int
                   ) -> tuple[pd.DataFrame, pd.DataFrame, dict]:
    """part and partsupp in dbgen's rules (spec 4.2.3), and their numpy
    columns: p_name is five distinct words of `tpch_data.COLORS` (dbgen
    draws from 92), p_type uniform over TYPE_S1 x TYPE_S2 x TYPE_S3,
    four partsupp rows per part, the i-th with supplier
    `part_suppkey(p, i)`."""
    p_partkey = np.arange(1, n_part + 1, dtype=np.int64)
    words = np.array(tpch_data.COLORS)[_distinct_words(rng, n_part, 5)]
    p_name = words[:, 0]
    for k in range(1, 5):
        p_name = np.char.add(np.char.add(p_name, " "), words[:, k])
    types = [f"{a} {b} {c}" for a in tpch_data.TYPE_S1
             for b in tpch_data.TYPE_S2 for c in tpch_data.TYPE_S3]
    p_type = rng.integers(0, len(types), n_part)
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    containers = [f"{a} {b}" for a in tpch_data.CONTAIN_S1
                  for b in tpch_data.CONTAIN_S2]
    part = pd.DataFrame({
        "p_partkey": p_partkey,
        "p_name": p_name.astype(object),
        "p_mfgr": _categorical([f"Manufacturer#{m}" for m in range(1, 6)],
                               mfgr - 1),
        "p_brand": _categorical([f"Brand#{b}" for b in range(11, 56)],
                                brand - 11),
        "p_type": _categorical(types, p_type),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": _categorical(containers, rng.integers(
            0, len(containers), n_part)),
        "p_retailprice": (90000 + (p_partkey // 10) % 20001
                          + 100 * (p_partkey % 1000)) / 100.0,
        "p_comment": _pooled(rng, n_part),
    })
    ps_partkey = np.repeat(p_partkey, 4)
    ps_supplycost = tpch_data._money(rng, 1.0, 1000.0, 4 * n_part)
    partsupp = pd.DataFrame({
        "ps_partkey": ps_partkey,
        "ps_suppkey": part_suppkey(ps_partkey, np.tile(np.arange(4), n_part),
                                   n_supp),
        "ps_availqty": rng.integers(1, 10_000, 4 * n_part).astype(np.int32),
        "ps_supplycost": ps_supplycost,
        "ps_comment": _pooled(rng, 4 * n_part),
    })
    green = np.zeros(n_part, bool)
    for k in range(5):
        green |= words[:, k] == "green"
    return part, partsupp, {"p_type": p_type, "p_green": green,
                            "ps_supplycost": ps_supplycost}


def sf10_tables(seed: int, sf: float = 10.0
                ) -> tuple[dict[str, pd.DataFrame], dict]:
    """(tables, numpy columns) of the eight TPC-H tables at scale factor
    `sf` (TPC-H spec 4.2.5: 10,000 suppliers, 150,000 customers,
    200,000 parts with 4 partsupp rows each and 1,500,000 orders per
    unit, 1-7 lines per order), linked by dbgen's keys (spec 4.2.3),
    drawn vectorized from `seed`:
      - o_orderkey is sparse as dbgen makes it, the first 8 keys of each
        block of 32;
      - o_custkey is never a multiple of 3 (a third of the customers
        place no order);
      - l_suppkey follows from l_partkey by dbgen's partsupp rule, one
        of the part's 4 suppliers, so every line has its partsupp row
        (at sf >= 0.023: below 229 suppliers the rule repeats a
        supplier for some parts, in dbgen too);
      - ship date = order date + 1..121, commit = order date + 30..90,
        receipt = ship date + 1..30; order status and total price
        follow from the lines.
    Columns follow `tpch_data.SCHEMAS`.  The strings the queries print
    or match have dbgen's widths: c_name `Customer#%09d`, c_address
    10-40 characters, c_comment 29-116 (pools of 4,096 strings); p_name
    is five distinct color words (`_part_partsupp`); the supplier's
    strings and o_comment follow `_supplier_strings` and
    `_order_comments` (drawn from a third stream, so every other column
    keeps its bytes for a seed); the other strings no query reads are
    pandas Categoricals over small pools.  The numpy
    columns hold what a golden needs: every key, the dates, prices,
    quantities and discounts, c_acctbal, ps_supplycost, and the codes
    of c_mktsegment (into `tpch_data.SEGMENTS`), o_orderpriority (into
    `tpch_data.PRIORITIES`), p_type (TYPE_S1 x TYPE_S2 x TYPE_S3 in
    order), l_returnflag (A/N/R = 0/1/2) and l_linestatus (F/O = 0/1),
    with l_linenumber, the p_name mask
    p_green of the parts whose name holds the word green, the o_comment
    mask o_special of Q13's '%special%requests%' and the s_comment mask
    s_complaint of Q16's '%Customer%Complaints%'."""
    rng = np.random.default_rng(seed)
    n_supp = int(10_000 * sf)
    n_cust = int(150_000 * sf)
    n_orders = int(1_500_000 * sf)
    n_part = int(200_000 * sf)
    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": _categorical(tpch_data.REGIONS, np.arange(5)),
        "r_comment": _pooled(rng, 5),
    })
    nations = len(tpch_data.NATIONS)
    n_regionkey = np.array([r for _, r in tpch_data.NATIONS], np.int64)
    nation = pd.DataFrame({
        "n_nationkey": np.arange(nations, dtype=np.int64),
        "n_name": _categorical([n for n, _ in tpch_data.NATIONS],
                               np.arange(nations)),
        "n_regionkey": n_regionkey,
        "n_comment": _pooled(rng, nations),
    })
    s_nationkey = rng.integers(0, nations, n_supp).astype(np.int64)
    # the strings of the queries past Q10 come from a third stream; the
    # main one still makes the draws of the pooled strings they replace
    rng3 = np.random.default_rng([seed, 3])
    s_strings, s_complaint = _supplier_strings(rng3, n_supp)
    _pooled(rng, n_supp)
    _pooled(rng, n_supp)
    s_phone = _phones(rng, s_nationkey)
    s_acctbal = tpch_data._money(rng, -999.99, 9999.99, n_supp)
    _pooled(rng, n_supp)
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": s_strings["s_name"],
        "s_address": s_strings["s_address"],
        "s_nationkey": s_nationkey,
        "s_phone": s_phone,
        "s_acctbal": s_acctbal,
        "s_comment": s_strings["s_comment"],
    })
    c_nationkey = rng.integers(0, nations, n_cust).astype(np.int64)
    c_segment = rng.integers(0, len(tpch_data.SEGMENTS), n_cust)
    c_custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    # the printed strings and part/partsupp come from a second stream;
    # the main one still makes the draws of the pooled strings they
    # replace, so every other column keeps its bytes for a seed
    rng2 = np.random.default_rng([seed, 2])
    _pooled(rng, n_cust)
    _pooled(rng, n_cust)
    c_phone = _phones(rng, c_nationkey)
    c_acctbal = tpch_data._money(rng, -999.99, 9999.99, n_cust)
    _pooled(rng, n_cust)
    customer = pd.DataFrame({
        "c_custkey": c_custkey,
        "c_name": np.char.add("Customer#", np.char.zfill(
            c_custkey.astype("U9"), 9)).astype(object),
        "c_address": _pick_pool(rng2, _vstrings(rng2, 10, 40), n_cust),
        "c_nationkey": c_nationkey,
        "c_phone": c_phone,
        "c_acctbal": c_acctbal,
        "c_mktsegment": _categorical(tpch_data.SEGMENTS, c_segment),
        "c_comment": _pick_pool(rng2, _texts(rng2, 29, 116), n_cust),
    })
    part, partsupp, p_arrays = _part_partsupp(rng2, n_part, n_supp)
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = i // 8 * 32 + i % 8 + 1
    # the j-th key that is no multiple of 3: 1, 2, 4, 5, 7, ...
    j = rng.integers(0, n_cust - n_cust // 3, n_orders)
    o_custkey = (j // 2 * 3 + j % 2 + 1).astype(np.int64)
    o_orderdate = rng.integers(tpch_data.days("1992-01-01"),
                               tpch_data.days("1998-08-02") + 1,
                               n_orders).astype(np.int32)
    o_priority = rng.integers(0, len(tpch_data.PRIORITIES), n_orders)
    lines = rng.integers(1, 8, n_orders)
    first = np.cumsum(lines) - lines
    n_lines = int(lines.sum())
    l_order = np.repeat(i, lines)
    l_partkey = rng.integers(1, n_part + 1, n_lines, dtype=np.int64)
    # dbgen's PART_SUPP_BRIDGE: the part's supplier number 0..3
    l_suppkey = part_suppkey(l_partkey, rng.integers(0, 4, n_lines), n_supp)
    lineitem, l_arrays = _lineitem(rng, o_orderdate[l_order], lambda _: {
        "l_orderkey": o_orderkey[l_order],
        "l_partkey": l_partkey,
        "l_suppkey": l_suppkey,
        "l_linenumber": (np.arange(n_lines) - first[l_order] + 1
                         ).astype(np.int32),
    })
    open_lines = np.add.reduceat(l_arrays["l_linestatus"].astype(np.int64),
                                 first)
    status = np.where(open_lines == 0, 0, np.where(open_lines == lines,
                                                   1, 2))
    o_comment, o_special = _order_comments(rng3, n_orders)
    charge = (l_arrays["l_extendedprice"] * (1.0 - l_arrays["l_discount"])
              * (1.0 + l_arrays["l_tax"]))
    orders = pd.DataFrame({
        "o_orderkey": o_orderkey,
        "o_custkey": o_custkey,
        "o_orderstatus": _categorical("FOP", status),
        "o_totalprice": np.round(np.add.reduceat(charge, first), 2),
        "o_orderdate": o_orderdate,
        "o_orderpriority": _categorical(tpch_data.PRIORITIES, o_priority),
        "o_clerk": _categorical(
            [f"Clerk#{k:09d}" for k in range(1, max(int(1000 * sf), 1) + 1)],
            rng.integers(0, max(int(1000 * sf), 1), n_orders)),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_comment": o_comment,
    })
    tables = {"region": region, "nation": nation, "supplier": supplier,
              "customer": customer, "part": part, "partsupp": partsupp,
              "orders": orders, "lineitem": lineitem}
    for name, df in tables.items():
        assert list(df.columns) == list(tpch_data.SCHEMAS[name].names), name
    arrays = {
        "n_regionkey": n_regionkey, "s_nationkey": s_nationkey,
        "c_nationkey": c_nationkey, "c_mktsegment": c_segment,
        "c_acctbal": c_acctbal, **p_arrays,
        "o_orderkey": o_orderkey, "o_custkey": o_custkey,
        "o_orderdate": o_orderdate, "o_orderpriority": o_priority,
        "o_special": o_special, "s_complaint": s_complaint,
        **{k: l_arrays[k] for k in (
            "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
            "l_quantity", "l_extendedprice", "l_discount", "l_returnflag",
            "l_linestatus", "l_shipdate", "l_commitdate",
            "l_receiptdate")}}
    return tables, arrays
