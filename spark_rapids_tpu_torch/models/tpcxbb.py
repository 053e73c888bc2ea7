"""TPCx-BB-like workload (port of spark_rapids_tpu/models/tpcxbb.py;
reference `integration_tests/.../tpcxbb/TpcxbbLikeSpark.scala` + the
`TpcxbbLikeBench` harness that produced the headline chart):
clickstream and sales analytics shapes over the TPC-DS generator's
tables (`tpcds_data`), a clickstream three times store_sales and a
product_reviews table.  All 30 of the reference's queries, built as
the reference builds them; q18 and q27 run their text analysis through a
Python UDF that the UDF compiler (udf/) turns into expressions.

Each query is `fn(t, run) -> CpuNode` over `sources(tables, n)`;
`run_query(name, tables)` runs one through the planner, on the card
unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Max, Sum
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen, Coalesce, If
from spark_rapids_tpu_torch.exprs.predicates import InSet
from spark_rapids_tpu_torch.exprs.string_fns import Contains
from spark_rapids_tpu_torch.models import tpcds_data
from spark_rapids_tpu_torch.models.data_util import make_sources
from spark_rapids_tpu_torch.models.tpcds_data import CATEGORIES
from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuFilter,
                                               CpuHashJoin, CpuLimit,
                                               CpuProject, CpuSort, CpuUnion)
from spark_rapids_tpu_torch.udf import tpu_udf

CLICKS_SCHEMA = T.Schema.of(
    ("wcs_click_date_sk", T.INT64), ("wcs_user_sk", T.INT64),
    ("wcs_item_sk", T.INT64), ("wcs_sales_sk", T.INT64))


def gen_clickstream(rng: np.random.Generator, n: int, n_items: int,
                    n_users: int, n_dates: int) -> pd.DataFrame:
    bought = rng.random(n) < 0.1
    return pd.DataFrame({
        "wcs_click_date_sk": rng.integers(0, n_dates, n).astype(np.int64),
        "wcs_user_sk": rng.integers(0, n_users, n).astype(np.int64),
        "wcs_item_sk": rng.integers(0, n_items, n).astype(np.int64),
        # -1 marks a view without purchase (nullable FK in the reference)
        "wcs_sales_sk": np.where(bought, rng.integers(0, n, n), -1)
        .astype(np.int64),
    })


REVIEWS_SCHEMA = T.Schema.of(
    ("pr_review_sk", T.INT64), ("pr_item_sk", T.INT64),
    ("pr_user_sk", T.INT64), ("pr_rating", T.INT32),
    ("pr_content", T.STRING))

_GOOD = ["good", "great", "excellent"]
_BAD = ["bad", "poor", "terrible"]


def gen_reviews(rng: np.random.Generator, n: int, n_items: int,
                n_users: int) -> pd.DataFrame:
    rating = rng.integers(1, 6, n)
    adj = [(_GOOD if r >= 4 else _BAD)[int(rng.integers(0, 3))]
           if r != 3 else "okay" for r in rating]
    noun = rng.choice(["value", "quality", "shipping", "design"], n)
    content = [f"{a} {b} overall" for a, b in zip(adj, noun)]
    return pd.DataFrame({
        "pr_review_sk": np.arange(n, dtype=np.int64),
        "pr_item_sk": rng.integers(0, n_items, n).astype(np.int64),
        "pr_user_sk": rng.integers(0, n_users, n).astype(np.int64),
        "pr_rating": rating.astype(np.int32),
        "pr_content": content,
    })


def gen_tables(rng: np.random.Generator, scale: int = 10_000):
    """TPC-DS tables, a clickstream sized 3x store_sales and
    max(scale // 2, 64) product reviews, drawn from `rng` in that
    order (the reference's frames from the same seed)."""
    tables = tpcds_data.gen_tables(rng, scale)
    n_items = len(tables["item"])
    n_users = len(tables["customer"])
    tables["web_clickstreams"] = gen_clickstream(
        rng, scale * 3, n_items, n_users, 365 * 5)
    tables["product_reviews"] = gen_reviews(
        rng, max(scale // 2, 64), n_items, n_users)
    return tables


def sources(tables, num_partitions: int = 1):
    extra = {"web_clickstreams": CLICKS_SCHEMA,
             "product_reviews": REVIEWS_SCHEMA}
    out = tpcds_data.sources(
        {k: v for k, v in tables.items() if k not in extra},
        num_partitions)
    out.update(make_sources({k: tables[k] for k in extra if k in tables},
                            extra, num_partitions))
    return out


def run_query(name: str, tables: dict, device="cuda",
              conf: Optional[C.RapidsConf] = None,
              num_partitions: int = 2):
    """TPCx-BB query `name` over `tables` (gen_tables' frames) through
    the planner on `device` (device="cuda" without a card raises),
    under BENCH_CONF unless `conf` is given."""
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = conf or C.RapidsConf(dict(BENCH_CONF))

    def run(plan):
        return collect(accelerate(plan, conf, device), conf)
    return run(QUERIES[name](sources(tables, num_partitions), run))


def q01_shape(t, run):
    """Top viewed categories (q01: frequently browsed together shape)."""
    j = CpuHashJoin(JoinType.INNER, [col("wcs_item_sk")],
                    [col("i_item_sk")], t["web_clickstreams"], t["item"])
    agg = CpuAggregate([col("i_category")],
                       [Count(None).alias("views")], j)
    return CpuSort([desc(col("views")), asc(col("i_category"))], agg)


def q05_shape(t, run):
    """Per-user views of a category vs purchases (logistic-features
    shape of q05)."""
    j = CpuHashJoin(JoinType.INNER, [col("wcs_item_sk")],
                    [col("i_item_sk")], t["web_clickstreams"], t["item"])
    flt = CpuFilter(InSet(col("i_category"),
                          ("Books", "Electronics")), j)
    agg = CpuAggregate(
        [col("wcs_user_sk")],
        [Count(None).alias("clicks"),
         Sum(_purchased()).alias("purchases")], flt)
    return CpuLimit(100, CpuSort(
        [desc(col("clicks")), asc(col("wcs_user_sk"))], agg))


def _purchased():
    return CaseWhen((((col("wcs_sales_sk") >= lit(0)), lit(1)),), lit(0))


def q12_shape(t, run):
    """Users who browsed then bought in a category window (semi join)."""
    j = CpuHashJoin(JoinType.INNER, [col("wcs_item_sk")],
                    [col("i_item_sk")], t["web_clickstreams"], t["item"])
    viewed = CpuFilter(
        InSet(col("i_category"), ("Home", "Music")) &
        (col("wcs_sales_sk") < lit(0)), j)
    buyers = CpuProject(
        [col("ss_customer_sk").alias("buyer_sk")],
        t["store_sales"])
    out = CpuHashJoin(JoinType.LEFT_SEMI, [col("wcs_user_sk")],
                      [col("buyer_sk")], viewed, buyers)
    agg = CpuAggregate([col("wcs_user_sk")],
                       [Count(None).alias("views")], out)
    return CpuLimit(100, CpuSort(
        [desc(col("views")), asc(col("wcs_user_sk"))], agg))


def q15_shape(t, run):
    """Category share of sales per store (q15 trend shape)."""
    j = CpuHashJoin(JoinType.INNER, [col("ss_item_sk")],
                    [col("i_item_sk")], t["store_sales"], t["item"])
    agg = CpuAggregate(
        [col("ss_store_sk"), col("i_category")],
        [Sum(col("ss_ext_sales_price")).alias("sales")], j)
    return CpuSort([asc(col("ss_store_sk")), desc(col("sales")),
                    asc(col("i_category"))], agg)


def q06_shape(t, run):
    """Customers whose second-half web spend grew vs the first half
    (reference q06's period-over-period ratio)."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = CpuHashJoin(JoinType.INNER, [col("d_date_sk")],
                    [col("ws_sold_date_sk")], dd, t["web_sales"])
    agg = CpuAggregate(
        [col("ws_bill_customer_sk")],
        [Sum(If(col("d_moy") <= lit(6), col("ws_net_paid"),
                lit(0.0))).alias("first_half"),
         Sum(If(col("d_moy") > lit(6), col("ws_net_paid"),
                lit(0.0))).alias("second_half")], j)
    grew = CpuFilter((col("first_half") > lit(0.0)) &
                     (col("second_half") > col("first_half")), agg)
    return CpuLimit(100, CpuSort(
        [desc(col("second_half")), asc(col("ws_bill_customer_sk"))],
        grew))


def q09_shape(t, run):
    """Store quantity over demographic x price-band slices (reference
    q09's OR'd slice sums)."""
    cd = CpuFilter(
        ((col("cd_marital_status") == lit("M")) &
         (col("cd_education_status") == lit("4 yr Degree"))) |
        ((col("cd_marital_status") == lit("S")) &
         (col("cd_education_status") == lit("Secondary"))),
        t["customer_demographics"])
    sales = CpuFilter(
        ((col("ss_sales_price") >= lit(50.0)) &
         (col("ss_sales_price") <= lit(100.0))) |
        ((col("ss_sales_price") >= lit(150.0)) &
         (col("ss_sales_price") <= lit(200.0))), t["store_sales"])
    j = CpuHashJoin(JoinType.INNER, [col("ss_cdemo_sk")],
                    [col("cd_demo_sk")], sales, cd)
    return CpuAggregate([], [Sum(col("ss_quantity")).alias("qty")], j)


def q14_shape(t, run):
    """Morning vs evening web order ratio (reference q14)."""
    j = CpuHashJoin(JoinType.INNER, [col("ws_sold_time_sk")],
                    [col("t_time_sk")], t["web_sales"], t["time_dim"])
    counts = CpuAggregate(
        [], [Sum(If((col("t_hour") >= lit(7)) & (col("t_hour") < lit(9)),
                    lit(1), lit(0))).alias("am_cnt"),
             Sum(If((col("t_hour") >= lit(19)) &
                    (col("t_hour") < lit(21)),
                    lit(1), lit(0))).alias("pm_cnt")], j)
    return CpuProject(
        [col("am_cnt"), col("pm_cnt"),
         (col("am_cnt") / col("pm_cnt")).alias("am_pm_ratio")], counts)


def q16_shape(t, run):
    """Web sales netted against returns around a pivot date (reference
    q16's before/after sums)."""
    j = CpuHashJoin(
        JoinType.LEFT_OUTER,
        [col("ws_order_number"), col("ws_item_sk")],
        [col("wr_order_number"), col("wr_item_sk")],
        t["web_sales"], t["web_returns"])
    j = CpuHashJoin(JoinType.INNER, [col("ws_sold_date_sk")],
                    [col("d_date_sk")], j,
                    CpuFilter(col("d_year") == lit(2001), t["date_dim"]))
    net = col("ws_sales_price") - Coalesce(
        (col("wr_return_amt"), lit(0.0)))
    return CpuAggregate(
        [], [Sum(If(col("d_moy") < lit(7), net, lit(0.0))).alias(
            "before"),
             Sum(If(col("d_moy") >= lit(7), net, lit(0.0))).alias(
            "after")], j)


def q17_shape(t, run):
    """Promotional share of store revenue in one category/month
    (reference q17's ratio of filtered to total sales)."""
    dd = CpuFilter((col("d_year") == lit(2000)) &
                   (col("d_moy") == lit(12)), t["date_dim"])
    it = CpuFilter(InSet(col("i_category"), ("Books", "Music")),
                   t["item"])
    base = CpuHashJoin(
        JoinType.INNER, [col("ss_item_sk")], [col("i_item_sk")],
        CpuHashJoin(JoinType.INNER, [col("d_date_sk")],
                    [col("ss_sold_date_sk")], dd, t["store_sales"]),
        it)
    promo = CpuHashJoin(
        JoinType.INNER, [col("ss_promo_sk")], [col("p_promo_sk")],
        base, CpuFilter((col("p_channel_email") == lit("Y")) |
                        (col("p_channel_event") == lit("Y")),
                        t["promotion"]))
    p_sum = CpuProject(
        [lit(1).alias("k1"), col("promotional")],
        CpuAggregate([], [Sum(col("ss_ext_sales_price")).alias(
            "promotional")], promo))
    t_sum = CpuProject(
        [lit(1).alias("k2"), col("total")],
        CpuAggregate([], [Sum(col("ss_ext_sales_price")).alias(
            "total")], base))
    j = CpuHashJoin(JoinType.INNER, [col("k1")], [col("k2")],
                    p_sum, t_sum)
    return CpuProject(
        [col("promotional"), col("total"),
         (col("promotional") / col("total") * lit(100.0)).alias(
             "promo_pct")], j)


def q20_shape(t, run):
    """Per-customer return-rate features for clustering (reference
    q20's order/amount return ratios)."""
    sales = CpuAggregate(
        [col("ss_customer_sk")],
        [Count(None).alias("orders"),
         Sum(col("ss_net_paid")).alias("spend")], t["store_sales"])
    rets = CpuAggregate(
        [col("sr_customer_sk")],
        [Count(None).alias("returns"),
         Sum(col("sr_return_amt")).alias("returned")],
        t["store_returns"])
    j = CpuHashJoin(JoinType.LEFT_OUTER, [col("ss_customer_sk")],
                    [col("sr_customer_sk")], sales, rets)
    out = CpuProject(
        [col("ss_customer_sk"),
         (Coalesce((col("returns"), lit(0))) * lit(1.0)
          / col("orders")).alias("return_order_ratio"),
         (Coalesce((col("returned"), lit(0.0)))
          / col("spend")).alias("return_amt_ratio")], j)
    return CpuLimit(100, CpuSort(
        [desc(col("return_amt_ratio")), asc(col("ss_customer_sk"))],
        out))


def q21_shape(t, run):
    """Items a customer returned and then re-bought through the
    catalog channel (reference q21's store->return->rebuy chain, with
    catalog as the re-buy channel)."""
    sr = CpuHashJoin(
        JoinType.INNER,
        [col("ss_item_sk"), col("ss_ticket_number")],
        [col("sr_item_sk"), col("sr_ticket_number")],
        t["store_sales"], t["store_returns"])
    re_buy = CpuHashJoin(
        JoinType.INNER,
        [col("sr_customer_sk"), col("sr_item_sk")],
        [col("cs_bill_customer_sk"), col("cs_item_sk")],
        sr, t["catalog_sales"])
    j = CpuHashJoin(JoinType.INNER, [col("sr_item_sk")],
                    [col("i_item_sk")], re_buy, t["item"])
    agg = CpuAggregate([col("i_item_id")],
                       [Count(None).alias("rebuys")], j)
    return CpuLimit(100, CpuSort(
        [desc(col("rebuys")), asc(col("i_item_id"))], agg))


def q22_shape(t, run):
    """Inventory on hand before vs after a pivot date per warehouse
    (reference q22's ratio-banded report)."""
    j = CpuHashJoin(JoinType.INNER, [col("inv_date_sk")],
                    [col("d_date_sk")], t["inventory"],
                    CpuFilter(col("d_year") == lit(2000), t["date_dim"]))
    agg = CpuAggregate(
        [col("inv_warehouse_sk"), col("inv_item_sk")],
        [Sum(If(col("d_moy") < lit(6), col("inv_quantity_on_hand"),
                lit(0))).alias("inv_before"),
         Sum(If(col("d_moy") >= lit(6), col("inv_quantity_on_hand"),
                lit(0))).alias("inv_after")], j)
    banded = CpuFilter(
        (col("inv_before") > lit(0)) &
        (col("inv_after") * lit(3) >= col("inv_before") * lit(2)) &
        (col("inv_after") * lit(2) <= col("inv_before") * lit(3)), agg)
    return CpuLimit(100, CpuSort(
        [asc(col("inv_warehouse_sk")), asc(col("inv_item_sk"))], banded))


def q29_shape(t, run):
    """Item pairs bought in the same catalog order (reference q29/q30
    affinity self-join)."""
    left = CpuProject(
        [col("cs_order_number").alias("o1"),
         col("cs_item_sk").alias("item_l")], t["catalog_sales"])
    right = CpuProject(
        [col("cs_order_number").alias("o2"),
         col("cs_item_sk").alias("item_r")], t["catalog_sales"])
    pairs = CpuFilter(
        col("item_l") < col("item_r"),
        CpuHashJoin(JoinType.INNER, [col("o1")], [col("o2")],
                    left, right))
    agg = CpuAggregate([col("item_l"), col("item_r")],
                       [Count(None).alias("cnt")], pairs)
    return CpuLimit(100, CpuSort(
        [desc(col("cnt")), asc(col("item_l")), asc(col("item_r"))], agg))


QUERIES = {"q01": q01_shape, "q05": q05_shape, "q06": q06_shape,
           "q09": q09_shape, "q12": q12_shape, "q14": q14_shape,
           "q15": q15_shape, "q16": q16_shape, "q17": q17_shape,
           "q20": q20_shape, "q21": q21_shape, "q22": q22_shape,
           "q29": q29_shape}


# ---------------------------------------------------------------------------
# round-2 growth toward the reference's 30 queries
# (TpcxbbLikeSpark.scala:785-2065): clickstream self-join shapes
# (q02/q03/q30), visit/abandonment funnels (q04/q08), pricing and
# segmentation (q07/q24/q25/q26), ratio reports (q11/q13/q23), and the
# NLP-ish review-sentiment family (q10/q19/q28) over a synthesized
# product_reviews table — the reference runs these as text UDFs over
# review bodies; the v0 shape uses literal-pattern Contains sentiment.
def _sentiment():
    """Contains-based polarity: +1 per good word, -1 per bad word —
    the literal-pattern stand-in for the reference's text UDF."""
    expr = lit(0)
    for w in _GOOD:
        expr = expr + If(Contains(col("pr_content"), lit(w)),
                         lit(1), lit(0))
    for w in _BAD:
        expr = expr - If(Contains(col("pr_content"), lit(w)),
                         lit(1), lit(0))
    return expr


def q02_shape(t, run):
    """Items co-viewed by the same user with a target item (reference
    q02's per-visit pair counts, user-keyed in the v0 shape)."""
    target = CpuProject(
        [col("wcs_user_sk").alias("tu")],
        CpuFilter(col("wcs_item_sk") == lit(7), t["web_clickstreams"]))
    co = CpuHashJoin(JoinType.LEFT_SEMI, [col("wcs_user_sk")],
                     [col("tu")], t["web_clickstreams"], target)
    other = CpuFilter(col("wcs_item_sk") != lit(7), co)
    agg = CpuAggregate([col("wcs_item_sk")],
                       [Count(None).alias("cnt")], other)
    return CpuLimit(30, CpuSort(
        [desc(col("cnt")), asc(col("wcs_item_sk"))], agg))


def q03_shape(t, run):
    """Views that preceded a purchase of the same item by the same user
    (reference q03's last-N-clicks-before-purchase funnel)."""
    buys = CpuProject(
        [col("wcs_user_sk").alias("bu"), col("wcs_item_sk").alias("bi"),
         col("wcs_click_date_sk").alias("bd")],
        CpuFilter(col("wcs_sales_sk") >= lit(0), t["web_clickstreams"]))
    views = CpuFilter(col("wcs_sales_sk") < lit(0),
                      t["web_clickstreams"])
    pair = CpuHashJoin(
        JoinType.INNER, [col("wcs_user_sk"), col("wcs_item_sk")],
        [col("bu"), col("bi")], views, buys,
        condition=col("wcs_click_date_sk") <= col("bd"))
    agg = CpuAggregate([col("wcs_item_sk")],
                       [Count(None).alias("prior_views")], pair)
    return CpuLimit(100, CpuSort(
        [desc(col("prior_views")), asc(col("wcs_item_sk"))], agg))


def q04_shape(t, run):
    """Per-user abandonment: users with views but zero purchases
    (reference q04's cart-abandonment funnel)."""
    agg = CpuAggregate(
        [col("wcs_user_sk")],
        [Count(None).alias("views"),
         Sum(_purchased()).alias("purchases")], t["web_clickstreams"])
    abandoned = CpuFilter(col("purchases") == lit(0), agg)
    return CpuLimit(100, CpuSort(
        [desc(col("views")), asc(col("wcs_user_sk"))], abandoned))


def q07_shape(t, run):
    """States whose customers buy high-priced items (reference q07)."""
    pricey = CpuFilter(col("i_current_price") > lit(60.0), t["item"])
    j = CpuHashJoin(JoinType.INNER, [col("i_item_sk")],
                    [col("ss_item_sk")], pricey, t["store_sales"])
    jc = CpuHashJoin(JoinType.INNER, [col("ss_customer_sk")],
                     [col("c_customer_sk")], j, t["customer"])
    ja = CpuHashJoin(JoinType.INNER, [col("c_current_addr_sk")],
                     [col("ca_address_sk")], jc, t["customer_address"])
    agg = CpuAggregate([col("ca_state")],
                       [Count(None).alias("cnt")], ja)
    return CpuLimit(10, CpuSort(
        [desc(col("cnt")), asc(col("ca_state"))],
        CpuFilter(col("cnt") >= lit(2), agg)))


def q08_shape(t, run):
    """Web sales from users who browsed first vs not (reference q08's
    reviewed-then-bought split)."""
    viewers = CpuProject(
        [col("wcs_user_sk").alias("vu")],
        CpuFilter(col("wcs_sales_sk") < lit(0), t["web_clickstreams"]))
    sales = CpuProject(
        [col("ws_bill_customer_sk").alias("cust"),
         col("ws_net_paid").alias("paid")], t["web_sales"])
    browsed = CpuHashJoin(JoinType.LEFT_SEMI, [col("cust")],
                          [col("vu")], sales, viewers)
    not_browsed = CpuHashJoin(JoinType.LEFT_ANTI, [col("cust")],
                              [col("vu")], sales, viewers)

    def summarize(label, side):
        return CpuProject(
            [lit(label).alias("cohort"), col("paid_sum"), col("cnt")],
            CpuAggregate([], [Sum(col("paid")).alias("paid_sum"),
                              Count(None).alias("cnt")], side))

    return CpuSort([asc(col("cohort"))],
                   CpuUnion(summarize("browsed", browsed),
                            summarize("other", not_browsed)))


def q10_shape(t, run):
    """Review sentiment per category (reference q10's sentiment UDF —
    literal-pattern polarity here)."""
    j = CpuHashJoin(JoinType.INNER, [col("pr_item_sk")],
                    [col("i_item_sk")], t["product_reviews"], t["item"])
    scored = CpuProject(
        [col("i_category"), _sentiment().alias("polarity"),
         col("pr_rating")], j)
    agg = CpuAggregate(
        [col("i_category")],
        [Sum(col("polarity")).alias("sentiment"),
         Count(None).alias("reviews")], scored)
    return CpuSort([asc(col("i_category"))], agg)


def q11_shape(t, run):
    """Review count vs sales per item (reference q11's correlation
    prep)."""
    r = CpuAggregate([col("pr_item_sk")],
                     [Count(None).alias("reviews"),
                      Sum(col("pr_rating")).alias("rating_sum")],
                     t["product_reviews"])
    s = CpuProject([col("ss_item_sk").alias("si"), col("sales")],
                   CpuAggregate(
                       [col("ss_item_sk")],
                       [Sum(col("ss_ext_sales_price")).alias("sales")],
                       t["store_sales"]))
    j = CpuHashJoin(JoinType.INNER, [col("pr_item_sk")], [col("si")],
                    r, s)
    return CpuLimit(100, CpuSort(
        [desc(col("sales")), asc(col("pr_item_sk"))],
        CpuProject([col("pr_item_sk"), col("reviews"),
                    col("rating_sum"), col("sales")], j)))


def q13_shape(t, run):
    """Customers' web vs store spend ratio (reference q13)."""
    w = CpuAggregate([col("ws_bill_customer_sk")],
                     [Sum(col("ws_net_paid")).alias("web_paid")],
                     t["web_sales"])
    s = CpuProject([col("ss_customer_sk").alias("sc"),
                    col("store_paid")],
                   CpuAggregate(
                       [col("ss_customer_sk")],
                       [Sum(col("ss_net_paid")).alias("store_paid")],
                       t["store_sales"]))
    j = CpuHashJoin(JoinType.INNER, [col("ws_bill_customer_sk")],
                    [col("sc")], w, s)
    keep = CpuFilter(col("store_paid") > lit(0.0), j)
    out = CpuProject(
        [col("ws_bill_customer_sk"),
         (col("web_paid") / col("store_paid")).alias("ratio")], keep)
    return CpuLimit(100, CpuSort(
        [desc(col("ratio")), asc(col("ws_bill_customer_sk"))], out))


def q19_shape(t, run):
    """Sentiment of reviews for returned items (reference q19)."""
    returned = CpuProject([col("sr_item_sk").alias("ri")],
                          t["store_returns"])
    rr = CpuHashJoin(JoinType.LEFT_SEMI, [col("pr_item_sk")],
                     [col("ri")], t["product_reviews"], returned)
    scored = CpuProject([col("pr_item_sk"),
                         _sentiment().alias("polarity")], rr)
    agg = CpuAggregate([col("pr_item_sk")],
                       [Sum(col("polarity")).alias("sentiment"),
                        Count(None).alias("reviews")], scored)
    return CpuLimit(100, CpuSort(
        [asc(col("sentiment")), asc(col("pr_item_sk"))], agg))


def q23_shape(t, run):
    """Inventory month-over-month swing per warehouse/item (reference
    q23's variance screen, avg-based in the v0 aggregate set)."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = CpuHashJoin(JoinType.INNER, [col("d_date_sk")],
                    [col("inv_date_sk")], dd, t["inventory"])
    monthly = CpuAggregate(
        [col("inv_warehouse_sk"), col("inv_item_sk"), col("d_moy")],
        [Sum(col("inv_quantity_on_hand")).alias("qty")], j)
    stats = CpuAggregate(
        [col("inv_warehouse_sk"), col("inv_item_sk")],
        [Sum(col("qty")).alias("total"), Count(None).alias("months")],
        monthly)
    return CpuLimit(100, CpuSort(
        [desc(col("total")), asc(col("inv_warehouse_sk")),
         asc(col("inv_item_sk"))],
        CpuFilter(col("months") >= lit(2), stats)))


def q24_shape(t, run):
    """Price sensitivity: sales volume of expensive vs cheap items per
    category (reference q24's elasticity shape)."""
    j = CpuHashJoin(JoinType.INNER, [col("ss_item_sk")],
                    [col("i_item_sk")], t["store_sales"], t["item"])
    flagged = CpuProject(
        [col("i_category"),
         If(col("i_current_price") > lit(50.0), col("ss_quantity"),
            lit(0)).alias("pricey_qty"),
         If(col("i_current_price") <= lit(50.0), col("ss_quantity"),
            lit(0)).alias("cheap_qty")], j)
    agg = CpuAggregate(
        [col("i_category")],
        [Sum(col("pricey_qty")).alias("pricey_qty"),
         Sum(col("cheap_qty")).alias("cheap_qty")], flagged)
    return CpuSort([asc(col("i_category"))], agg)


def q25_shape(t, run):
    """Customer recency/frequency/monetary segmentation prep (reference
    q25's k-means feature build)."""
    agg = CpuAggregate(
        [col("ss_customer_sk")],
        [Max(col("ss_sold_date_sk")).alias("recency"),
         Count(None).alias("frequency"),
         Sum(col("ss_net_paid")).alias("monetary")], t["store_sales"])
    return CpuLimit(100, CpuSort(
        [desc(col("monetary")), asc(col("ss_customer_sk"))], agg))


def q26_shape(t, run):
    """Per-customer category spend pivot (reference q26's cluster
    features: one column per category via conditional sums)."""
    j = CpuHashJoin(JoinType.INNER, [col("ss_item_sk")],
                    [col("i_item_sk")], t["store_sales"], t["item"])
    aggs = []
    for c in CATEGORIES[:5]:
        aggs.append(Sum(If(col("i_category") == lit(c),
                           col("ss_net_paid"), lit(0.0)))
                    .alias(f"spend_{c.lower()}"))
    agg = CpuAggregate([col("ss_customer_sk")], aggs, j)
    return CpuLimit(100, CpuSort(
        [asc(col("ss_customer_sk"))], agg))


def q28_shape(t, run):
    """Classifier data prep: deterministic hash split of reviews into
    train/test with per-split rating histograms (reference q28's naive
    bayes prep)."""
    split = CpuProject(
        [col("pr_rating"),
         If((col("pr_review_sk") % lit(10)) < lit(8),
            lit("train"), lit("test")).alias("part")],
        t["product_reviews"])
    agg = CpuAggregate([col("part"), col("pr_rating")],
                       [Count(None).alias("cnt")], split)
    return CpuSort([asc(col("part")), asc(col("pr_rating"))], agg)


def q30_shape(t, run):
    """Category affinity: pairs of categories viewed by the same user
    (reference q30's co-occurrence matrix)."""
    j = CpuHashJoin(JoinType.INNER, [col("wcs_item_sk")],
                    [col("i_item_sk")], t["web_clickstreams"], t["item"])
    a = CpuProject([col("wcs_user_sk").alias("ua"),
                    col("i_category_id").alias("cat_a")], j)
    b = CpuProject([col("wcs_user_sk").alias("ub"),
                    col("i_category_id").alias("cat_b")], j)
    pairs = CpuHashJoin(JoinType.INNER, [col("ua")], [col("ub")], a, b,
                        condition=col("cat_a") < col("cat_b"))
    agg = CpuAggregate([col("cat_a"), col("cat_b")],
                       [Count(None).alias("cnt")], pairs)
    return CpuLimit(100, CpuSort(
        [desc(col("cnt")), asc(col("cat_a")), asc(col("cat_b"))], agg))


QUERIES.update({
    "q02": q02_shape, "q03": q03_shape, "q04": q04_shape,
    "q07": q07_shape, "q08": q08_shape, "q10": q10_shape,
    "q11": q11_shape, "q13": q13_shape, "q19": q19_shape,
    "q23": q23_shape, "q24": q24_shape, "q25": q25_shape,
    "q26": q26_shape, "q28": q28_shape, "q30": q30_shape,
})



# q18 and q27: the reference's Q18Like/Q27Like throw ("uses UDF",
# TpcxbbLikeSpark.scala:1455,1993); here the text analysis is a Python
# UDF over the review content that the UDF compiler (udf/) turns into
# expressions that run on the card.
@tpu_udf(T.INT64)
def review_sentiment(content):
    """BigBench q18-style sentiment: -1 negative, +1 positive, else 0."""
    if content is None:
        return 0
    if (content.find("bad") >= 0 or content.find("poor") >= 0 or
            content.find("terrible") >= 0):
        return -1
    if (content.find("good") >= 0 or content.find("great") >= 0 or
            content.find("excellent") >= 0):
        return 1
    return 0


@tpu_udf(T.INT64)
def mentions_aspect(content):
    """BigBench q27-style extraction flag: does the review name the
    product aspect competitors fight on (quality or value)."""
    if content is None:
        return 0
    if content.find("quality") >= 0 or content.find("value") >= 0:
        return 1
    return 0


def _join(left, right, lk, rk, jt=JoinType.INNER):
    return CpuHashJoin(jt, [col(k) for k in lk], [col(k) for k in rk],
                       left, right)


def q18(t, run):
    """q18-like: the sentiment of reviews of items sold by declining
    stores (Q1 against Q2 sales), through the compiled sentiment UDF."""
    # Q1 against Q2, not the halves: the generator's December holiday
    # weight would make every store grow in H2
    dd1 = CpuFilter((col("d_year") == lit(1999)) &
                    (col("d_moy") <= lit(3)), t["date_dim"])
    dd2 = CpuFilter((col("d_year") == lit(1999)) &
                    (col("d_moy") >= lit(4)) &
                    (col("d_moy") <= lit(6)), t["date_dim"])

    def half(dd, alias, key):
        j = _join(CpuProject([col("d_date_sk").alias(key)], dd),
                  t["store_sales"], [key], ["ss_sold_date_sk"])
        return CpuAggregate([col("ss_store_sk").alias(f"sk_{alias}")],
                            [Sum(col("ss_net_paid")).alias(alias)], j)

    declining = CpuFilter(
        col("h2") < col("h1"),
        _join(half(dd1, "h1", "d1sk"), half(dd2, "h2", "d2sk"),
              ["sk_h1"], ["sk_h2"]))
    # the items those stores sold
    items = CpuAggregate(
        [col("it")], [Count(None).alias("_c")],
        _join(CpuProject([col("sk_h1").alias("decl_sk")], declining),
              CpuProject([col("ss_store_sk").alias("st"),
                          col("ss_item_sk").alias("it")],
                         t["store_sales"]),
              ["decl_sk"], ["st"]))
    rv = _join(t["product_reviews"], items, ["pr_item_sk"], ["it"],
               jt=JoinType.LEFT_SEMI)
    scored = CpuProject(
        [col("pr_item_sk"),
         review_sentiment(col("pr_content")).alias("sentiment")], rv)
    agg = CpuAggregate(
        [col("sentiment")], [Count(None).alias("review_count")], scored)
    return CpuSort([asc(col("sentiment"))], agg)


def q27(t, run):
    """q27-like: per-item counts of competitive-aspect mentions and the
    rating, through the compiled extraction UDF."""
    flagged = CpuProject(
        [col("pr_item_sk"), col("pr_rating"),
         mentions_aspect(col("pr_content")).alias("mention")],
        t["product_reviews"])
    agg = CpuAggregate(
        [col("pr_item_sk")],
        [Sum(col("mention")).alias("mentions"),
         Count(None).alias("n_reviews"),
         Average(col("pr_rating")).alias("avg_rating")], flagged)
    out = CpuFilter(col("mentions") > lit(0), agg)
    return CpuLimit(100, CpuSort(
        [desc(col("mentions")), asc(col("pr_item_sk"))], out))


QUERIES.update({"q18": q18, "q27": q27})
