"""TPC-H table schemas and dbgen-shaped synthetic data (port of
spark_rapids_tpu/models/tpch_data.py: the same draws from the same rng,
so one seed gives both packages the same tables).

Dates are stored as int32 days-since-epoch (the engine's DATE32 storage
model).  Key relationships (orderkey/custkey/partkey/suppkey/nationkey/
regionkey) are referentially consistent so every join has matches.
"""
from __future__ import annotations

import datetime as pydt

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T

EPOCH = pydt.date(1970, 1, 1)


def days(s: str) -> int:
    """'1994-01-01' -> int32 days since epoch (DATE32 literal helper)."""
    return (pydt.date.fromisoformat(s) - EPOCH).days


REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey) — the 25 dbgen nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
            "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
              "5-LOW"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAIN_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAIN_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
          "dim", "dodger", "drab", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "hotpink", "indian", "ivory", "khaki"]

SCHEMAS = {
    "region": T.Schema.of(
        ("r_regionkey", T.INT64), ("r_name", T.STRING),
        ("r_comment", T.STRING)),
    "nation": T.Schema.of(
        ("n_nationkey", T.INT64), ("n_name", T.STRING),
        ("n_regionkey", T.INT64), ("n_comment", T.STRING)),
    "supplier": T.Schema.of(
        ("s_suppkey", T.INT64), ("s_name", T.STRING),
        ("s_address", T.STRING), ("s_nationkey", T.INT64),
        ("s_phone", T.STRING), ("s_acctbal", T.FLOAT64),
        ("s_comment", T.STRING)),
    "customer": T.Schema.of(
        ("c_custkey", T.INT64), ("c_name", T.STRING),
        ("c_address", T.STRING), ("c_nationkey", T.INT64),
        ("c_phone", T.STRING), ("c_acctbal", T.FLOAT64),
        ("c_mktsegment", T.STRING), ("c_comment", T.STRING)),
    "part": T.Schema.of(
        ("p_partkey", T.INT64), ("p_name", T.STRING),
        ("p_mfgr", T.STRING), ("p_brand", T.STRING),
        ("p_type", T.STRING), ("p_size", T.INT32),
        ("p_container", T.STRING), ("p_retailprice", T.FLOAT64),
        ("p_comment", T.STRING)),
    "partsupp": T.Schema.of(
        ("ps_partkey", T.INT64), ("ps_suppkey", T.INT64),
        ("ps_availqty", T.INT32), ("ps_supplycost", T.FLOAT64),
        ("ps_comment", T.STRING)),
    "orders": T.Schema.of(
        ("o_orderkey", T.INT64), ("o_custkey", T.INT64),
        ("o_orderstatus", T.STRING), ("o_totalprice", T.FLOAT64),
        ("o_orderdate", T.DATE32), ("o_orderpriority", T.STRING),
        ("o_clerk", T.STRING), ("o_shippriority", T.INT32),
        ("o_comment", T.STRING)),
    "lineitem": T.Schema.of(
        ("l_orderkey", T.INT64), ("l_partkey", T.INT64),
        ("l_suppkey", T.INT64), ("l_linenumber", T.INT32),
        ("l_quantity", T.FLOAT64), ("l_extendedprice", T.FLOAT64),
        ("l_discount", T.FLOAT64), ("l_tax", T.FLOAT64),
        ("l_returnflag", T.STRING), ("l_linestatus", T.STRING),
        ("l_shipdate", T.DATE32), ("l_commitdate", T.DATE32),
        ("l_receiptdate", T.DATE32), ("l_shipinstruct", T.STRING),
        ("l_shipmode", T.STRING), ("l_comment", T.STRING)),
}


def _pick(rng, options, n):
    return np.array(options, dtype=object)[
        rng.integers(0, len(options), n)]


#: nations the query suite predicates on (FRANCE/GERMANY q7, BRAZIL q8,
#: CANADA q20, SAUDI ARABIA q21, GERMANY q11, ASIA-region INDIA/CHINA for
#: q5) get elevated draw weight so tiny test scales still produce
#: qualifying rows — dbgen at SF>=1 gets density from volume instead
_HOT_NATIONS = (2, 3, 6, 7, 8, 18, 20)


def _nation_keys(rng, n):
    w = np.ones(len(NATIONS))
    w[list(_HOT_NATIONS)] = 8.0
    return rng.choice(len(NATIONS), size=n, p=w / w.sum()).astype(
        np.int64)


def _money(rng, lo, hi, n):
    return np.round(rng.uniform(lo, hi, n), 2)


def _comment(rng, n, specials=()):
    """Random word-ish comments; `specials` phrases are planted in ~8% of
    rows so LIKE-predicate queries (Q13/Q16/Q19) select non-empty sets."""
    base = _pick(rng, COLORS, n)
    mid = _pick(rng, COLORS, n)
    out = np.array([f"{a} {b} requests" for a, b in zip(base, mid)],
                   dtype=object)
    for phrase in specials:
        hit = rng.random(n) < 0.08
        out[hit] = np.array([f"{a} {phrase} {b} requests"
                             for a, b in zip(base[hit], mid[hit])],
                            dtype=object)
    return out


def gen_tables(rng: np.random.Generator, scale: int = 1000
               ) -> dict[str, pd.DataFrame]:
    """Generate all 8 tables; `scale` ~ lineitem row count.  Row ratios
    follow dbgen (orders = scale/4, part = scale/5, etc., floored small)."""
    n_orders = max(scale // 4, 20)
    n_part = max(scale // 5, 20)
    n_supp = max(scale // 100, 5)
    n_cust = max(scale // 10, 15)
    n_ps = n_part * 2

    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": _comment(rng, 5),
    })
    nation = pd.DataFrame({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int64),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], np.int64),
        "n_comment": _comment(rng, len(NATIONS)),
    })
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(n_supp)],
                           dtype=object),
        "s_address": _comment(rng, n_supp),
        "s_nationkey": _nation_keys(rng, n_supp),
        "s_phone": np.array(
            [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-"
             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for _ in range(n_supp)], dtype=object),
        "s_acctbal": _money(rng, -999.99, 9999.99, n_supp),
        "s_comment": _comment(rng, n_supp,
                              specials=["Customer", "Complaints"]),
    })
    # plant the Q16 phrase as one token so both engines match it
    hit = rng.random(n_supp) < 0.1
    supplier.loc[hit, "s_comment"] = "Customer Complaints " + \
        supplier.loc[hit, "s_comment"]
    customer = pd.DataFrame({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(n_cust)],
                           dtype=object),
        "c_address": _comment(rng, n_cust),
        "c_nationkey": _nation_keys(rng, n_cust),
        "c_phone": np.array(
            [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-"
             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for _ in range(n_cust)], dtype=object),
        "c_acctbal": _money(rng, -999.99, 9999.99, n_cust),
        "c_mktsegment": _pick(rng, SEGMENTS, n_cust),
        "c_comment": _comment(rng, n_cust, specials=["special"]),
    })
    part = pd.DataFrame({
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_name": np.array(
            [("forest " if rng.random() < 0.05 else "") +
             " ".join(rng.choice(COLORS, 3, replace=False))
             for _ in range(n_part)], dtype=object),
        "p_mfgr": np.array(
            [f"Manufacturer#{rng.integers(1, 6)}"
             for _ in range(n_part)], dtype=object),
        "p_brand": np.array(
            [f"Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}"
             for _ in range(n_part)], dtype=object),
        "p_type": np.array(
            ["ECONOMY ANODIZED STEEL" if rng.random() < 0.05 else
             "LARGE POLISHED BRASS" if rng.random() < 0.08 else
             f"{rng.choice(TYPE_S1)} {rng.choice(TYPE_S2)} "
             f"{rng.choice(TYPE_S3)}" for _ in range(n_part)],
            dtype=object),
        "p_size": np.where(rng.random(n_part) < 0.04, 15,
                           rng.integers(1, 51, n_part)).astype(np.int32),
        "p_container": np.array(
            [f"{rng.choice(CONTAIN_S1)} {rng.choice(CONTAIN_S2)}"
             for _ in range(n_part)], dtype=object),
        "p_retailprice": _money(rng, 900.0, 2000.0, n_part),
        "p_comment": _comment(rng, n_part),
    })
    partsupp = pd.DataFrame({
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int64), 2),
        "ps_suppkey": rng.integers(0, n_supp, n_ps).astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int32),
        "ps_supplycost": _money(rng, 1.0, 1000.0, n_ps),
        "ps_comment": _comment(rng, n_ps),
    }).drop_duplicates(["ps_partkey", "ps_suppkey"],
                       ignore_index=True)
    odate = rng.integers(days("1992-01-01"), days("1998-08-02"),
                         n_orders).astype(np.int32)
    orders = pd.DataFrame({
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cust, n_orders).astype(np.int64),
        "o_orderstatus": _pick(rng, ["F", "O", "P"], n_orders),
        "o_totalprice": _money(rng, 1000.0, 400000.0, n_orders),
        "o_orderdate": odate,
        "o_orderpriority": _pick(rng, PRIORITIES, n_orders),
        "o_clerk": np.array(
            [f"Clerk#{rng.integers(1, 1000):09d}"
             for _ in range(n_orders)], dtype=object),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_comment": _comment(rng, n_orders,
                              specials=["special", "pending", "deposits",
                                        "accounts"]),
    })
    ps_pairs = partsupp["ps_suppkey"].to_numpy().reshape(-1)
    part_first = np.searchsorted(
        partsupp["ps_partkey"].to_numpy(),
        np.arange(n_part))
    part_count = np.diff(np.append(part_first, len(partsupp)))
    l_order = rng.integers(0, n_orders, scale).astype(np.int64)
    ship_delay = rng.integers(1, 122, scale).astype(np.int32)
    l_ship = odate[l_order] + ship_delay
    # commit windows sized so ~25% of lines are late (receipt > commit):
    # q21's "sole late supplier in a multi-supplier order" pattern needs
    # late lines to be the exception, not the rule
    l_commit = odate[l_order] + rng.integers(60, 151, scale).astype(
        np.int32)
    l_receipt = l_ship + rng.integers(1, 31, scale).astype(np.int32)
    l_part = rng.integers(0, n_part, scale).astype(np.int64)
    pick = rng.integers(0, 1 << 30, scale) % np.maximum(
        part_count[l_part], 1)
    l_supp = ps_pairs[part_first[l_part] + pick]
    qty = rng.integers(1, 51, scale).astype(np.float64)
    price = np.round(qty * rng.uniform(900.0, 2000.0, scale), 2)
    lineitem = pd.DataFrame({
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": rng.integers(1, 8, scale).astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": np.round(rng.uniform(0.0, 0.11, scale), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.09, scale), 2),
        "l_returnflag": _pick(rng, ["A", "N", "R"], scale),
        "l_linestatus": _pick(rng, ["F", "O"], scale),
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": _pick(rng, INSTRUCTIONS, scale),
        "l_shipmode": _pick(rng, SHIP_MODES, scale),
        "l_comment": _comment(rng, scale),
    })
    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


def sources(tables: dict[str, pd.DataFrame], num_partitions: int = 1):
    """Wrap generated tables as CpuSource plan leaves with the declared
    schemas (DATE32 columns stay int32 storage)."""
    from spark_rapids_tpu_torch.models.data_util import make_sources
    return make_sources(tables, SCHEMAS, num_partitions)
