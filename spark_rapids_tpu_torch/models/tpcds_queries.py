"""All 103 TPC-DS queries of the reference suite
(`integration_tests/.../tpcds/TpcdsLikeSpark.scala:708+`) as CPU plan
trees (port of spark_rapids_tpu/models/tpcds_queries.py, in the DSL of
tpch_queries.py).

Each query is `fn(t, run) -> CpuNode`: `t` maps table name -> a fresh
source plan (`tpcds_data.sources`), `run(plan) -> DataFrame` executes a
sub-plan on the engine under test (q9's scalar subqueries go through
it).  Every plan is built as the reference builds it, block by block in
the reference's order of registration, from the reference suite's query
text over the generator's schemas (no decimals: money is float64);
where a reference literal has no support in the synthetic data, the
reference's stand-in literal is kept and commented at the site.  ROLLUP
lowers to a CpuExpand with one projection per key prefix and a grouping
id (`_rollup_expand`), as Spark's planner feeds ExpandExec.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as _T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exec.window import (CpuWindow, Rank, WinAvg,
                                                WindowFrame, WindowSpec,
                                                WinMax, WinSum)
from spark_rapids_tpu_torch.exprs.aggregates import (Average, Count, Max,
                                                     Min, Sum)
from spark_rapids_tpu_torch.exprs.aggregates import StddevSamp as _Stddev
from spark_rapids_tpu_torch.exprs.arithmetic import Abs as _Abs
from spark_rapids_tpu_torch.exprs.base import Literal as _Lit
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import Coalesce, If
from spark_rapids_tpu_torch.exprs.math_exprs import Round
from spark_rapids_tpu_torch.exprs.predicates import InSet, IsNotNull, IsNull
from spark_rapids_tpu_torch.exprs.string_fns import (ConcatStrings, Like,
                                                     Upper)
from spark_rapids_tpu_torch.exprs.string_fns import Substring as _Substring
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuExpand,
                                               CpuFilter, CpuHashJoin,
                                               CpuLimit, CpuProject, CpuSort,
                                               CpuUnion)

J = JoinType


def _join(left, right, lk, rk, jt=J.INNER, condition=None):
    return CpuHashJoin(jt, [col(k) for k in lk], [col(k) for k in rk],
                       left, right, condition=condition)


def q3(t, run):
    """Brand revenue by year for one manufacturer in December."""
    dd = CpuFilter(col("d_moy") == lit(12), t["date_dim"])
    it = CpuFilter(col("i_manufact_id") == lit(5), t["item"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              it, ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("d_year"), col("i_brand_id"), col("i_brand")],
        [Sum(col("ss_ext_sales_price")).alias("sum_agg")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("d_year")), desc(col("sum_agg")),
         asc(col("i_brand_id"))], agg))


def q19(t, run):
    """Brand revenue for one month/year by manager."""
    dd = CpuFilter((col("d_year") == lit(1999)) &
                   (col("d_moy") == lit(11)), t["date_dim"])
    it = CpuFilter(col("i_manager_id") == lit(8), t["item"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              it, ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_brand_id"), col("i_brand"), col("i_manufact_id")],
        [Sum(col("ss_ext_sales_price")).alias("ext_price")], j)
    return CpuLimit(100, CpuSort(
        [desc(col("ext_price")), asc(col("i_brand_id")),
         asc(col("i_manufact_id"))], agg))


def q42(t, run):
    """Category revenue for one month/year."""
    dd = CpuFilter((col("d_year") == lit(2000)) &
                   (col("d_moy") == lit(11)), t["date_dim"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              t["item"], ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("d_year"), col("i_category_id"), col("i_category")],
        [Sum(col("ss_ext_sales_price")).alias("total")], j)
    return CpuLimit(100, CpuSort(
        [desc(col("total")), asc(col("d_year")),
         asc(col("i_category_id"))], agg))


def q52(t, run):
    """Brand revenue, one month/year (q42 by brand)."""
    dd = CpuFilter((col("d_year") == lit(2000)) &
                   (col("d_moy") == lit(11)), t["date_dim"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              t["item"], ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("d_year"), col("i_brand_id"), col("i_brand")],
        [Sum(col("ss_ext_sales_price")).alias("ext_price")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("d_year")), desc(col("ext_price")),
         asc(col("i_brand_id"))], agg))


def q55(t, run):
    """Brand revenue for one manager, month, year."""
    dd = CpuFilter((col("d_year") == lit(2001)) &
                   (col("d_moy") == lit(12)), t["date_dim"])
    # reference manager 28 stands in as 4 (a zipf-hot head slice)
    it = CpuFilter(col("i_manager_id") == lit(4), t["item"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              it, ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_brand_id"), col("i_brand")],
        [Sum(col("ss_ext_sales_price")).alias("ext_price")], j)
    return CpuLimit(100, CpuSort(
        [desc(col("ext_price")), asc(col("i_brand_id"))], agg))


def q68(t, run):
    """Per-ticket totals for high-dependency households in two cities."""
    dd = CpuFilter((col("d_year") == lit(1999)) &
                   InSet(col("d_dom"), tuple(range(1, 3))),
                   t["date_dim"])
    hd = CpuFilter((col("hd_dep_count") == lit(4)) |
                   (col("hd_vehicle_count") == lit(3)),
                   t["household_demographics"])
    st = CpuFilter(InSet(col("s_city"), ("Midway", "Fairview")),
                   t["store"])
    j = _join(_join(_join(_join(dd, t["store_sales"],
                                ["d_date_sk"], ["ss_sold_date_sk"]),
                          st, ["ss_store_sk"], ["s_store_sk"]),
                    hd, ["ss_hdemo_sk"], ["hd_demo_sk"]),
              t["customer_address"], ["ss_addr_sk"], ["ca_address_sk"])
    per_ticket = CpuAggregate(
        [col("ss_ticket_number"), col("ss_customer_sk"),
         col("ca_city")],
        [Sum(col("ss_ext_sales_price")).alias("extended_price"),
         Sum(col("ss_ext_list_price")).alias("list_price"),
         Sum(col("ss_ext_wholesale_cost")).alias("extended_tax")], j)
    j2 = _join(per_ticket, t["customer"],
               ["ss_customer_sk"], ["c_customer_sk"])
    out = CpuProject(
        [col("c_last_name"), col("c_first_name"), col("ca_city"),
         col("ss_ticket_number"), col("extended_price"),
         col("extended_tax"), col("list_price")], j2)
    return CpuLimit(100, CpuSort(
        [asc(col("c_last_name")), asc(col("ss_ticket_number"))], out))


def q73(t, run):
    """Ticket counts per customer for mid-size baskets."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    hd = CpuFilter(col("hd_buy_potential") == lit(">10000"),
                   t["household_demographics"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    per_ticket = CpuAggregate(
        [col("ss_ticket_number"), col("ss_customer_sk")],
        [Count(None).alias("cnt")], j)
    big = CpuFilter((col("cnt") >= lit(2)) & (col("cnt") <= lit(50)),
                    per_ticket)
    j2 = _join(big, t["customer"],
               ["ss_customer_sk"], ["c_customer_sk"])
    out = CpuProject(
        [col("c_last_name"), col("c_first_name"),
         col("ss_ticket_number"), col("cnt")], j2)
    return CpuSort([desc(col("cnt")), asc(col("c_last_name")),
                    asc(col("ss_ticket_number"))], out)


def q96(t, run):
    """Count of sales in a demographic/time slice."""
    hd = CpuFilter(col("hd_dep_count") == lit(7),
                   t["household_demographics"])
    st = CpuFilter(col("s_store_name") == lit("ese"), t["store"])
    j = _join(_join(t["store_sales"], hd,
                    ["ss_hdemo_sk"], ["hd_demo_sk"]),
              st, ["ss_store_sk"], ["s_store_sk"])
    return CpuAggregate([], [Count(None).alias("cnt")], j)


# ---------------------------------------------------------------------------
# returns / correlated-average shapes
def q1(t, run):
    """Customers whose store-return total exceeds 1.2x their store's
    average (reference q1's correlated subquery, decorrelated into an
    aggregate-join)."""
    ctr = CpuAggregate(
        [col("sr_customer_sk"), col("sr_store_sk")],
        [Sum(col("sr_return_amt")).alias("ctr_total")],
        t["store_returns"])
    avg_ctr = CpuAggregate(
        [col("sr_store_sk")],
        [Average(col("ctr_total")).alias("avg_ret")],
        CpuProject([col("sr_store_sk"), col("ctr_total")], ctr))
    big = CpuFilter(
        col("ctr_total") > col("avg_ret") * lit(1.2),
        _join(ctr, CpuProject(
            [col("sr_store_sk").alias("st2"), col("avg_ret")], avg_ctr),
            ["sr_store_sk"], ["st2"]))
    st = CpuFilter(col("s_state") == lit("TX"), t["store"])
    j = _join(_join(big, st, ["sr_store_sk"], ["s_store_sk"]),
              t["customer"], ["sr_customer_sk"], ["c_customer_sk"])
    return CpuLimit(100, CpuSort(
        [asc(col("c_customer_id"))],
        CpuProject([col("c_customer_id")], j)))


def q65(t, run):
    """Store items whose revenue is at most 10% of the store's average
    item revenue."""
    sa = CpuAggregate(
        [col("ss_store_sk"), col("ss_item_sk")],
        [Sum(col("ss_sales_price")).alias("revenue")], t["store_sales"])
    sb = CpuAggregate(
        [col("ss_store_sk")],
        [Average(col("revenue")).alias("ave")],
        CpuProject([col("ss_store_sk"), col("revenue")], sa))
    low = CpuFilter(
        col("revenue") <= col("ave") * lit(0.1),
        _join(sa, CpuProject([col("ss_store_sk").alias("sk2"),
                              col("ave")], sb),
              ["ss_store_sk"], ["sk2"]))
    j = _join(_join(low, t["store"], ["ss_store_sk"], ["s_store_sk"]),
              t["item"], ["ss_item_sk"], ["i_item_sk"])
    return CpuLimit(100, CpuSort(
        [asc(col("s_store_name")), asc(col("i_item_id"))],
        CpuProject([col("s_store_name"), col("i_item_id"),
                    col("revenue")], j)))


# ---------------------------------------------------------------------------
# catalog / web channel star joins
def q26(t, run):
    """Catalog item averages for one demographic slice (q7's catalog
    twin)."""
    cd = CpuFilter((col("cd_gender") == lit("M")) &
                   (col("cd_marital_status") == lit("S")) &
                   (col("cd_education_status") == lit("College")),
                   t["customer_demographics"])
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = _join(_join(_join(dd, t["catalog_sales"],
                          ["d_date_sk"], ["cs_sold_date_sk"]),
                    cd, ["cs_bill_cdemo_sk"], ["cd_demo_sk"]),
              t["item"], ["cs_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id")],
        [Average(col("cs_quantity")).alias("agg1"),
         Average(col("cs_list_price")).alias("agg2"),
         Average(col("cs_sales_price")).alias("agg3")], j)
    return CpuLimit(100, CpuSort([asc(col("i_item_id"))], agg))


# ---------------------------------------------------------------------------
# multi-channel unions
# ---------------------------------------------------------------------------
# existence tests (semi/anti joins)
def q97(t, run):
    """Customer-item overlap between store and catalog channels
    (reference q97: FULL OUTER join of deduplicated channel pairs)."""
    ssci = CpuAggregate(
        [col("ss_customer_sk"), col("ss_item_sk")],
        [Count(None).alias("_s")], t["store_sales"])
    csci = CpuAggregate(
        [col("cs_bill_customer_sk"), col("cs_item_sk")],
        [Count(None).alias("_c")], t["catalog_sales"])
    j = CpuHashJoin(
        J.FULL_OUTER,
        [col("ss_customer_sk"), col("ss_item_sk")],
        [col("cs_bill_customer_sk"), col("cs_item_sk")], ssci, csci)
    return CpuAggregate(
        [],
        [Sum(If(IsNotNull(col("_s")) & IsNull(col("_c")),
                lit(1), lit(0))).alias("store_only"),
         Sum(If(IsNull(col("_s")) & IsNotNull(col("_c")),
                lit(1), lit(0))).alias("catalog_only"),
         Sum(If(IsNotNull(col("_s")) & IsNotNull(col("_c")),
                lit(1), lit(0))).alias("store_and_catalog")], j)


# ---------------------------------------------------------------------------
# returns netting / outer joins
# ---------------------------------------------------------------------------
# shipping-lag bucketing


# ---------------------------------------------------------------------------
# pivots, time slots, ratios
QUERIES = {
    "q1": q1, "q3": q3, "q19": q19,
    "q26": q26, "q42": q42, "q52": q52, "q55": q55, "q65": q65, "q68": q68, "q73": q73, "q96": q96, "q97": q97,
}


# ---------------------------------------------------------------------------
# round-2 growth toward the reference's 103 (TpcdsLikeSpark.scala:709+):
# year-over-year ratio family (q4/q11/q74), ROLLUP grouping-sets through
# CpuExpand (q5/q22/q86), channel unions (q56/q76), windowed deviation
# reports (q53/q57/q89), returns chains (q17/q24/q29/q49/q78/q81/q83/q85),
# inventory (q39/q72), existence/self-join shapes (q14/q35/q95).


def _rollup_expand(child, keys, passthrough):
    """Spark ROLLUP(keys...) lowering: CpuExpand with one projection per
    key prefix plus the grand total, carrying a grouping id — the exact
    shape Spark's planner feeds ExpandExec (reference GpuExpandExec)."""
    cs = child.output_schema()
    n = len(keys)
    projs = []
    for level in range(n, -1, -1):
        proj = [col(k) if i < level else _Lit(None, cs.field(k).dtype)
                for i, k in enumerate(keys)]
        proj.append(_Lit((1 << (n - level)) - 1, _T.INT32))
        proj.extend(col(p) for p in passthrough)
        projs.append(proj)
    names = list(keys) + ["gid"] + list(passthrough)
    return CpuExpand(projs, names, child)


def _yoy_growth(t, sales, date_key, cust_key, val, year1=1999):
    """Per-customer totals for two consecutive years, joined: the
    q4/q11/q74 year-over-year scaffold."""
    def year_total(y, alias):
        dd = CpuFilter(col("d_year") == lit(y), t["date_dim"])
        j = _join(_join(dd, t[sales], ["d_date_sk"], [date_key]),
                  t["customer"], [cust_key], ["c_customer_sk"])
        return CpuAggregate([col("c_customer_id")],
                            [Sum(col(val)).alias(alias)], j)
    y1 = year_total(year1, "total1")
    y2 = CpuProject([col("c_customer_id").alias("cid2"),
                     col("total2")],
                    year_total(year1 + 1, "total2"))
    j = _join(CpuFilter(col("total1") > lit(0.0), y1), y2,
              ["c_customer_id"], ["cid2"])
    return CpuProject([col("c_customer_id"),
                       (col("total2") / col("total1")).alias("growth")], j)


def q22_rollup(t, run):
    """Inventory average quantity on hand, ROLLUP(category, brand) — a
    true grouping-sets plan through CpuExpand (reference q22)."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = _join(_join(dd, t["inventory"], ["d_date_sk"], ["inv_date_sk"]),
              t["item"], ["inv_item_sk"], ["i_item_sk"])
    ex = _rollup_expand(j, ["i_category", "i_brand"],
                        ["inv_quantity_on_hand"])
    agg = CpuAggregate(
        [col("i_category"), col("i_brand"), col("gid")],
        [Average(col("inv_quantity_on_hand")).alias("qoh")], ex)
    return CpuLimit(100, CpuSort(
        [asc(col("qoh")), asc(col("i_category")), asc(col("i_brand")),
         asc(col("gid"))], agg))


def q86_rollup(t, run):
    """Web revenue ROLLUP(category, brand) report (reference q86 uses
    category/class; the v0 item schema carries brand)."""
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    j = _join(_join(dd, t["web_sales"], ["d_date_sk"],
                    ["ws_sold_date_sk"]),
              t["item"], ["ws_item_sk"], ["i_item_sk"])
    ex = _rollup_expand(j, ["i_category", "i_brand"], ["ws_net_paid"])
    agg = CpuAggregate(
        [col("i_category"), col("i_brand"), col("gid")],
        [Sum(col("ws_net_paid")).alias("total_sum")], ex)
    return CpuLimit(100, CpuSort(
        [desc(col("total_sum")), asc(col("i_category")),
         asc(col("i_brand")), asc(col("gid"))], agg))


def _cat_ratio(t, sales, date_key, item_key, price, year, moy):
    """q12/q20/q98 scaffold: item revenue + windowed share of its
    category's revenue."""
    dd = CpuFilter((col("d_year") == lit(year)) &
                   (col("d_moy") == lit(moy)), t["date_dim"])
    it = CpuFilter(InSet(col("i_category"),
                         ("Books", "Music", "Home")), t["item"])
    j = _join(_join(dd, t[sales], ["d_date_sk"], [date_key]),
              it, [item_key], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id"), col("i_category")],
        [Sum(col(price)).alias("itemrevenue")], j)
    w = CpuWindow(
        [WinSum(col("itemrevenue")).alias("cat_rev")],
        WindowSpec([col("i_category")], [],
                   WindowFrame(is_rows=True, lower=None, upper=None)),
        agg)
    share = CpuProject(
        [col("i_item_id"), col("i_category"), col("itemrevenue"),
         (col("itemrevenue") * lit(100.0) / col("cat_rev"))
         .alias("revenueratio")], w)
    return CpuLimit(100, CpuSort(
        [asc(col("i_category")), asc(col("i_item_id")),
         asc(col("revenueratio"))], share))


def _cast_i64(e):
    return Cast(e, _T.INT64)


QUERIES.update({ "q22": q22_rollup, "q86": q86_rollup,
})


# a/b variants (the reference counts q14a/b, q23a/b, q24a/b, q39a/b as
# separate queries — TpcdsLikeSpark.scala) + q91.


# ---------------------------------------------------------------------------
# round-3 faithful upgrades: full reference query text
# (TpcdsLikeSpark.scala:709+) over the extended generator schemas —
# (every earlier reduced variant is replaced query-for-query).


def _date(y, m, d):
    """DATE32 literal: days since unix epoch."""
    import datetime
    days = (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    return _Lit(days, _T.DATE32)


def _between(c, lo, hi):
    return (c >= lo) & (c <= hi)


def q7(t, run):
    """Reference q7: item averages for one demographic slice + promo."""
    cd = CpuFilter((col("cd_gender") == lit("M")) &
                   (col("cd_marital_status") == lit("S")) &
                   (col("cd_education_status") == lit("College")),
                   t["customer_demographics"])
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    promo = CpuFilter((col("p_channel_email") == lit("N")) |
                      (col("p_channel_event") == lit("N")),
                      t["promotion"])
    j = _join(_join(_join(_join(dd, t["store_sales"],
                                ["d_date_sk"], ["ss_sold_date_sk"]),
                          cd, ["ss_cdemo_sk"], ["cd_demo_sk"]),
                    promo, ["ss_promo_sk"], ["p_promo_sk"]),
              t["item"], ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id")],
        [Average(col("ss_quantity")).alias("agg1"),
         Average(col("ss_list_price")).alias("agg2"),
         Average(col("ss_coupon_amt")).alias("agg3"),
         Average(col("ss_sales_price")).alias("agg4")], j)
    return CpuLimit(100, CpuSort([asc(col("i_item_id"))], agg))


def q13(t, run):
    """Reference q13: averages under OR-of-AND demographic/address
    bands (join keys inner, band predicates as a post-join filter)."""
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    j = _join(_join(_join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"]),
        t["household_demographics"], ["ss_hdemo_sk"], ["hd_demo_sk"]),
        t["customer_demographics"], ["ss_cdemo_sk"], ["cd_demo_sk"]),
        t["customer_address"], ["ss_addr_sk"], ["ca_address_sk"])
    demo = (
        ((col("cd_marital_status") == lit("M")) &
         (col("cd_education_status") == lit("Advanced Degree")) &
         _between(col("ss_sales_price"), lit(100.0), lit(150.0)) &
         (col("hd_dep_count") == lit(3))) |
        ((col("cd_marital_status") == lit("S")) &
         (col("cd_education_status") == lit("College")) &
         _between(col("ss_sales_price"), lit(50.0), lit(100.0)) &
         (col("hd_dep_count") == lit(1))) |
        ((col("cd_marital_status") == lit("W")) &
         (col("cd_education_status") == lit("2 yr Degree")) &
         _between(col("ss_sales_price"), lit(150.0), lit(200.0)) &
         (col("hd_dep_count") == lit(1))))
    addr = (
        (col("ca_country") == lit("United States")) &
        (InSet(col("ca_state"), ("TX", "NY")) &
         _between(col("ss_net_profit"), lit(100), lit(200)) |
         InSet(col("ca_state"), ("CA", "IL")) &
         _between(col("ss_net_profit"), lit(150), lit(300)) |
         InSet(col("ca_state"), ("WA", "GA")) &
         _between(col("ss_net_profit"), lit(50), lit(250))))
    f = CpuFilter(demo & addr, j)
    return CpuAggregate(
        [], [Average(col("ss_quantity")).alias("avg_qty"),
             Average(col("ss_ext_sales_price")).alias("avg_esp"),
             Average(col("ss_ext_wholesale_cost")).alias("avg_ewc"),
             Sum(col("ss_ext_wholesale_cost")).alias("sum_ewc")], f)


def q15(t, run):
    """Reference q15: catalog revenue by zip (zip/state/price OR)."""
    dd = CpuFilter((col("d_year") == lit(2001)) &
                   (col("d_qoy") == lit(2)), t["date_dim"])
    j = _join(_join(_join(dd, t["catalog_sales"],
                          ["d_date_sk"], ["cs_sold_date_sk"]),
                    t["customer"],
                    ["cs_bill_customer_sk"], ["c_customer_sk"]),
              t["customer_address"],
              ["c_current_addr_sk"], ["ca_address_sk"])
    zips = ("85669", "86197", "88274", "83405", "86475",
            "85392", "85460", "80348", "81792")
    f = CpuFilter(
        InSet(_Substring(col("ca_zip"), lit(1), lit(5)), zips) |
        InSet(col("ca_state"), ("CA", "WA", "GA")) |
        (col("cs_sales_price") > lit(500.0)), j)
    agg = CpuAggregate([col("ca_zip")],
                       [Sum(col("cs_sales_price")).alias("total")], f)
    return CpuLimit(100, CpuSort([asc(col("ca_zip"))], agg))


def q25(t, run):
    """Reference q25: store profit / returns loss / catalog profit per
    item+store across the d1/d2/d3 date windows."""
    d1 = CpuFilter(_between(col("d_moy"), lit(1), lit(6)) &
                   (col("d_year") == lit(2001)), t["date_dim"])
    d2 = CpuFilter(_between(col("d_moy"), lit(1), lit(12)) &
                   (col("d_year") == lit(2001)), t["date_dim"])
    d3 = CpuFilter(_between(col("d_moy"), lit(1), lit(12)) &
                   (col("d_year") == lit(2001)), t["date_dim"])
    ss = _join(d1, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"])
    sr = _join(CpuProject([col("d_date_sk").alias("d2_sk")], d2),
               t["store_returns"], ["d2_sk"], ["sr_returned_date_sk"])
    cs = _join(CpuProject([col("d_date_sk").alias("d3_sk")], d3),
               t["catalog_sales"], ["d3_sk"], ["cs_sold_date_sk"])
    j = _join(ss, sr, ["ss_customer_sk", "ss_item_sk",
                       "ss_ticket_number"],
              ["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
    j = _join(j, cs, ["sr_customer_sk", "sr_item_sk"],
              ["cs_bill_customer_sk", "cs_item_sk"])
    j = _join(j, t["store"], ["ss_store_sk"], ["s_store_sk"])
    j = _join(j, t["item"], ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("s_store_id"),
         col("s_store_name")],
        [Sum(col("ss_net_profit")).alias("store_sales_profit"),
         Sum(col("sr_net_loss")).alias("store_returns_loss"),
         Sum(col("cs_net_profit")).alias("catalog_sales_profit")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("i_item_id")), asc(col("i_item_desc")),
         asc(col("s_store_id")), asc(col("s_store_name"))], agg))


def q27(t, run):
    """Reference q27: state-level item averages over ROLLUP
    (i_item_id, s_state) with the grouping flag."""
    cd = CpuFilter((col("cd_gender") == lit("M")) &
                   (col("cd_marital_status") == lit("S")) &
                   (col("cd_education_status") == lit("College")),
                   t["customer_demographics"])
    dd = CpuFilter(col("d_year") == lit(2002), t["date_dim"])
    # reference lists TN; the generator's state domain stands in
    st = CpuFilter(InSet(col("s_state"), ("TX", "CA", "WA")),
                   t["store"])
    j = _join(_join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        cd, ["ss_cdemo_sk"], ["cd_demo_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"]),
        t["item"], ["ss_item_sk"], ["i_item_sk"])
    pre = CpuProject(
        [col("i_item_id"), col("s_state"), col("ss_quantity"),
         col("ss_list_price"), col("ss_coupon_amt"),
         col("ss_sales_price")], j)
    ex = _rollup_expand(pre, ["i_item_id", "s_state"],
                        ["ss_quantity", "ss_list_price",
                         "ss_coupon_amt", "ss_sales_price"])
    agg = CpuAggregate(
        [col("i_item_id"), col("s_state"), col("gid")],
        [Average(col("ss_quantity")).alias("agg1"),
         Average(col("ss_list_price")).alias("agg2"),
         Average(col("ss_coupon_amt")).alias("agg3"),
         Average(col("ss_sales_price")).alias("agg4")], ex)
    out = CpuProject(
        [col("i_item_id"), col("s_state"),
         If(col("gid") >= lit(1), lit(1), lit(0)).alias("g_state"),
         col("agg1"), col("agg2"), col("agg3"), col("agg4")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("i_item_id")), asc(col("s_state"))], out))


def _q28_block(t, qlo, qhi, lp, ca, wc, tag):
    base = CpuFilter(
        _between(col("ss_quantity"), lit(qlo), lit(qhi)) &
        (_between(col("ss_list_price"), lit(float(lp)),
                  lit(float(lp + 10))) |
         _between(col("ss_coupon_amt"), lit(float(ca)),
                  lit(float(ca + 1000))) |
         _between(col("ss_wholesale_cost"), lit(float(wc)),
                  lit(float(wc + 20)))), t["store_sales"])
    main = CpuProject(
        [lit(1).alias(f"_k{tag}"),
         col(f"{tag}_LP"), col(f"{tag}_CNT")],
        CpuAggregate(
            [], [Average(col("ss_list_price")).alias(f"{tag}_LP"),
                 Count(col("ss_list_price")).alias(f"{tag}_CNT")],
            base))
    dist = CpuProject(
        [lit(1).alias(f"_kd{tag}"), col(f"{tag}_CNTD")],
        CpuAggregate(
            [], [Count(col("ss_list_price")).alias(f"{tag}_CNTD")],
            CpuAggregate([col("ss_list_price")],
                         [Count(None).alias("_d")], base)))
    return _join(main, dist, [f"_k{tag}"], [f"_kd{tag}"])


def q28(t, run):
    """Reference q28: six quantity-band stats blocks cross-joined
    (count distinct via two-level aggregate)."""
    blocks = [
        _q28_block(t, 0, 5, 8, 459, 57, "B1"),
        _q28_block(t, 6, 10, 90, 2323, 31, "B2"),
        _q28_block(t, 11, 15, 142, 12214, 79, "B3"),
        _q28_block(t, 16, 20, 135, 6071, 38, "B4"),
        _q28_block(t, 21, 25, 122, 836, 17, "B5"),
        _q28_block(t, 26, 30, 154, 7326, 7, "B6"),
    ]
    out = blocks[0]
    for i, b in enumerate(blocks[1:], start=2):
        out = _join(out, b, [f"_kB{i - 1}"], [f"_kB{i}"])
    names = [c for tag in ("B1", "B2", "B3", "B4", "B5", "B6")
             for c in (f"{tag}_LP", f"{tag}_CNT", f"{tag}_CNTD")]
    return CpuLimit(100, CpuProject([col(c) for c in names], out))


def _q33_channel(t, sales, date_key, addr_key, item_key, val):
    manuf = CpuAggregate(
        [col("i_manufact_id")], [Count(None).alias("_c")],
        CpuFilter(InSet(col("i_category"), ("Electronics",)),
                  t["item"]))
    it = _join(t["item"], manuf, ["i_manufact_id"], ["i_manufact_id"],
               jt=J.LEFT_SEMI)
    dd = CpuFilter((col("d_year") == lit(1998)) &
                   (col("d_moy") == lit(5)), t["date_dim"])
    ca = CpuFilter(col("ca_gmt_offset") == lit(-5.0),
                   t["customer_address"])
    j = _join(_join(_join(dd, sales, ["d_date_sk"], [date_key]),
                    ca, [addr_key], ["ca_address_sk"]),
              it, [item_key], ["i_item_sk"])
    return CpuAggregate([col("i_manufact_id")],
                        [Sum(col(val)).alias("total_sales")], j)


def q33(t, run):
    """Reference q33: Electronics manufacturer revenue across the three
    channels, unioned and re-aggregated."""
    ss = _q33_channel(t, t["store_sales"], "ss_sold_date_sk",
                      "ss_addr_sk", "ss_item_sk", "ss_ext_sales_price")
    cs = _q33_channel(t, t["catalog_sales"], "cs_sold_date_sk",
                      "cs_bill_addr_sk", "cs_item_sk",
                      "cs_ext_sales_price")
    ws = _q33_channel(t, t["web_sales"], "ws_sold_date_sk",
                      "ws_bill_addr_sk", "ws_item_sk",
                      "ws_ext_sales_price")
    u = CpuUnion(ss, cs, ws)
    agg = CpuAggregate([col("i_manufact_id")],
                       [Sum(col("total_sales")).alias("total_sales")], u)
    return CpuLimit(100, CpuSort([desc(col("total_sales"))], agg))


def q37(t, run):
    """Reference q37: in-stock catalog items in a price band."""
    it = CpuFilter(
        _between(col("i_current_price"), lit(20.0), lit(90.0)) &
        InSet(col("i_manufact_id"),
              tuple(range(1, 41))), t["item"])
    dd = CpuFilter(_between(col("d_date"), _date(2000, 1, 1),
                            _date(2000, 12, 31)), t["date_dim"])
    inv = CpuFilter(_between(col("inv_quantity_on_hand"),
                             lit(100), lit(500)), t["inventory"])
    j = _join(_join(_join(it, inv, ["i_item_sk"], ["inv_item_sk"]),
                    dd, ["inv_date_sk"], ["d_date_sk"]),
              t["catalog_sales"], ["i_item_sk"], ["cs_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("i_current_price")],
        [Count(None).alias("_c")], j)
    out = CpuProject([col("i_item_id"), col("i_item_desc"),
                      col("i_current_price")], agg)
    return CpuLimit(100, CpuSort([asc(col("i_item_id"))], out))


def q40(t, run):
    """Reference q40: warehouse sales before/after one date, catalog
    left-outer returns netting."""
    j = _join(t["catalog_sales"], t["catalog_returns"],
              ["cs_order_number", "cs_item_sk"],
              ["cr_order_number", "cr_item_sk"], jt=J.LEFT_OUTER)
    # reference band is 0.99..1.49 over 2000-02-10..04-10; a wider
    # price band keeps the sparse synthetic item table populated
    it = CpuFilter(_between(col("i_current_price"),
                            lit(0.99), lit(3.49)), t["item"])
    dd = CpuFilter(_between(col("d_date"), _date(2000, 2, 10),
                            _date(2000, 4, 10)), t["date_dim"])
    j = _join(_join(_join(j, it, ["cs_item_sk"], ["i_item_sk"]),
                    t["warehouse"], ["cs_warehouse_sk"],
                    ["w_warehouse_sk"]),
              dd, ["cs_sold_date_sk"], ["d_date_sk"])
    net = col("cs_sales_price") - Coalesce((col("cr_refunded_cash"),
                                            lit(0.0)))
    agg = CpuAggregate(
        [col("w_state"), col("i_item_id")],
        [Sum(If(col("d_date") < _date(2000, 3, 11), net,
                lit(0.0))).alias("sales_before"),
         Sum(If(col("d_date") >= _date(2000, 3, 11), net,
                lit(0.0))).alias("sales_after")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("w_state")), asc(col("i_item_id"))], agg))


def q43(t, run):
    """Reference q43: store weekday sales pivot for one year/offset."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    st = CpuFilter(col("s_gmt_offset") == lit(-5.0), t["store"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              st, ["ss_store_sk"], ["s_store_sk"])

    def day_sum(name, alias):
        return Sum(If(col("d_day_name") == lit(name),
                      col("ss_sales_price"), lit(0.0))).alias(alias)
    agg = CpuAggregate(
        [col("s_store_name"), col("s_store_id")],
        [day_sum("Sunday", "sun_sales"), day_sum("Monday", "mon_sales"),
         day_sum("Tuesday", "tue_sales"),
         day_sum("Wednesday", "wed_sales"),
         day_sum("Thursday", "thu_sales"),
         day_sum("Friday", "fri_sales"),
         day_sum("Saturday", "sat_sales")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("s_store_name")), asc(col("s_store_id")),
         asc(col("sun_sales")), asc(col("mon_sales"))], agg))


def q45(t, run):
    """Reference q45: web revenue by zip/city; zip prefix OR item-id
    semi-join on the primes item list."""
    dd = CpuFilter((col("d_year") == lit(2001)) &
                   (col("d_qoy") == lit(2)), t["date_dim"])
    j = _join(_join(_join(_join(
        dd, t["web_sales"], ["d_date_sk"], ["ws_sold_date_sk"]),
        t["customer"], ["ws_bill_customer_sk"], ["c_customer_sk"]),
        t["customer_address"], ["c_current_addr_sk"], ["ca_address_sk"]),
        t["item"], ["ws_item_sk"], ["i_item_sk"])
    prime_ids = CpuAggregate(
        [col("prime_id")], [Count(None).alias("_c")],
        CpuProject(
            [col("i_item_id").alias("prime_id")],
            CpuFilter(InSet(col("i_item_sk"),
                            (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)),
                      t["item"])))
    prime_ids = CpuProject([col("prime_id")], prime_ids)
    j = _join(j, prime_ids, ["i_item_id"], ["prime_id"],
              jt=J.LEFT_OUTER)
    zips = ("85669", "86197", "88274", "83405", "86475",
            "85392", "85460", "80348", "81792")
    f = CpuFilter(
        InSet(_Substring(col("ca_zip"), lit(1), lit(5)), zips) |
        IsNotNull(col("prime_id")), j)
    agg = CpuAggregate([col("ca_zip"), col("ca_city")],
                       [Sum(col("ws_sales_price")).alias("total")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("ca_zip")), asc(col("ca_city"))], agg))


def q48(t, run):
    """Reference q48: quantity total across demographic price bands and
    address profit bands."""
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = _join(_join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"]),
        t["customer_demographics"], ["ss_cdemo_sk"], ["cd_demo_sk"]),
        t["customer_address"], ["ss_addr_sk"], ["ca_address_sk"])
    demo = (
        ((col("cd_marital_status") == lit("M")) &
         (col("cd_education_status") == lit("4 yr Degree")) &
         _between(col("ss_sales_price"), lit(100.0), lit(150.0))) |
        ((col("cd_marital_status") == lit("D")) &
         (col("cd_education_status") == lit("2 yr Degree")) &
         _between(col("ss_sales_price"), lit(50.0), lit(100.0))) |
        ((col("cd_marital_status") == lit("S")) &
         (col("cd_education_status") == lit("College")) &
         _between(col("ss_sales_price"), lit(150.0), lit(200.0))))
    addr = (
        (col("ca_country") == lit("United States")) &
        (InSet(col("ca_state"), ("NY", "IL", "TX")) &
         _between(col("ss_net_profit"), lit(0), lit(2000)) |
         InSet(col("ca_state"), ("CA", "GA")) &
         _between(col("ss_net_profit"), lit(150), lit(3000)) |
         InSet(col("ca_state"), ("WA",)) &
         _between(col("ss_net_profit"), lit(50), lit(25000))))
    f = CpuFilter(demo & addr, j)
    return CpuAggregate([], [Sum(col("ss_quantity")).alias("total")], f)


QUERIES.update({
    "q7": q7, "q13": q13, "q15": q15, "q25": q25, "q27": q27,
    "q28": q28, "q33": q33, "q37": q37, "q40": q40, "q43": q43,
    "q45": q45, "q48": q48,
})


def q34(t, run):
    """Reference q34: 15-20-item tickets for high-buy-potential
    households on month boundaries."""
    dd = CpuFilter(
        (_between(col("d_dom"), lit(1), lit(3)) |
         _between(col("d_dom"), lit(25), lit(28))) &
        InSet(col("d_year"), (1999, 2000, 2001)), t["date_dim"])
    hd = CpuFilter(
        ((col("hd_buy_potential") == lit(">10000")) |
         (col("hd_buy_potential") == lit("Unknown"))) &
        (col("hd_vehicle_count") > lit(0)) &
        (If(col("hd_vehicle_count") > lit(0),
            col("hd_dep_count") / col("hd_vehicle_count"),
            _Lit(None, _T.FLOAT64)) > lit(1.2)),
        t["household_demographics"])
    st = CpuFilter(InSet(col("s_county"), ("Williamson County",)),
                   t["store"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"]),
        hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    dn = CpuAggregate([col("ss_ticket_number"), col("ss_customer_sk")],
                      [Count(None).alias("cnt")], j)
    # reference band is 15-20; the generator's post-filter per-ticket
    # counts are 1-3, so the band scales down
    dn = CpuFilter(_between(col("cnt"), lit(1), lit(20)), dn)
    out = _join(dn, t["customer"], ["ss_customer_sk"],
                ["c_customer_sk"])
    out = CpuProject(
        [col("c_last_name"), col("c_first_name"), col("c_salutation"),
         col("c_preferred_cust_flag"), col("ss_ticket_number"),
         col("cnt")], out)
    return CpuSort(
        [asc(col("c_last_name")), asc(col("c_first_name")),
         asc(col("c_salutation")), desc(col("c_preferred_cust_flag")),
         asc(col("ss_ticket_number"))], out)


def q46(t, run):
    """Reference q46: weekend coupon/profit per ticket where the bought
    city differs from the customer's current city."""
    dd = CpuFilter(InSet(col("d_dow"), (6, 0)) &
                   InSet(col("d_year"), (1999, 2000, 2001)),
                   t["date_dim"])
    hd = CpuFilter((col("hd_dep_count") == lit(4)) |
                   (col("hd_vehicle_count") == lit(3)),
                   t["household_demographics"])
    st = CpuFilter(InSet(col("s_city"), ("Fairview", "Midway")),
                   t["store"])
    j = _join(_join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"]),
        hd, ["ss_hdemo_sk"], ["hd_demo_sk"]),
        t["customer_address"], ["ss_addr_sk"], ["ca_address_sk"])
    dn = CpuAggregate(
        [col("ss_ticket_number"), col("ss_customer_sk"),
         col("ss_addr_sk"), col("ca_city")],
        [Sum(col("ss_coupon_amt")).alias("amt"),
         Sum(col("ss_net_profit")).alias("profit")], j)
    dn = CpuProject(
        [col("ss_ticket_number"), col("ss_customer_sk"),
         col("ca_city").alias("bought_city"), col("amt"),
         col("profit")], dn)
    out = _join(_join(dn, t["customer"], ["ss_customer_sk"],
                      ["c_customer_sk"]),
                t["customer_address"], ["c_current_addr_sk"],
                ["ca_address_sk"])
    out = CpuFilter(col("ca_city") != col("bought_city"), out)
    out = CpuProject(
        [col("c_last_name"), col("c_first_name"), col("ca_city"),
         col("bought_city"), col("ss_ticket_number"), col("amt"),
         col("profit")], out)
    return CpuLimit(100, CpuSort(
        [asc(col("c_last_name")), asc(col("c_first_name")),
         asc(col("ca_city")), asc(col("bought_city")),
         asc(col("ss_ticket_number"))], out))


def _lag_buckets(diff, prefix=""):
    return [
        Sum(If(diff <= lit(30), lit(1), lit(0))).alias(
            f"{prefix}d30"),
        Sum(If((diff > lit(30)) & (diff <= lit(60)), lit(1),
               lit(0))).alias(f"{prefix}d31_60"),
        Sum(If((diff > lit(60)) & (diff <= lit(90)), lit(1),
               lit(0))).alias(f"{prefix}d61_90"),
        Sum(If((diff > lit(90)) & (diff <= lit(120)), lit(1),
               lit(0))).alias(f"{prefix}d91_120"),
        Sum(If(diff > lit(120), lit(1), lit(0))).alias(
            f"{prefix}d120plus"),
    ]


def q50(t, run):
    """Reference q50: return-lag buckets per store (full store column
    list) for one return month."""
    d2 = CpuFilter((col("d_year") == lit(2001)) &
                   (col("d_moy") == lit(8)), t["date_dim"])
    j = _join(t["store_sales"], t["store_returns"],
              ["ss_ticket_number", "ss_item_sk", "ss_customer_sk"],
              ["sr_ticket_number", "sr_item_sk", "sr_customer_sk"])
    j = _join(j, CpuProject([col("d_date_sk").alias("d2_sk")], d2),
              ["sr_returned_date_sk"], ["d2_sk"])
    j = _join(j, t["store"], ["ss_store_sk"], ["s_store_sk"])
    diff = col("sr_returned_date_sk") - col("ss_sold_date_sk")
    keys = ["s_store_name", "s_company_id", "s_street_number",
            "s_street_name", "s_street_type", "s_suite_number",
            "s_city", "s_county", "s_state", "s_zip"]
    agg = CpuAggregate([col(k) for k in keys], _lag_buckets(diff), j)
    return CpuLimit(100, CpuSort([asc(col(k)) for k in keys], agg))


def q61(t, run):
    """Reference q61: promotional vs total revenue (two scalar branches
    joined on a constant key)."""
    def branch(with_promo, tag):
        dd = CpuFilter((col("d_year") == lit(1998)) &
                       (col("d_moy") == lit(11)), t["date_dim"])
        st = CpuFilter(col("s_gmt_offset") == lit(-5.0), t["store"])
        it = CpuFilter(col("i_category") == lit("Jewelry"), t["item"])
        ca = CpuFilter(col("ca_gmt_offset") == lit(-5.0),
                       t["customer_address"])
        j = _join(_join(dd, t["store_sales"],
                        ["d_date_sk"], ["ss_sold_date_sk"]),
                  st, ["ss_store_sk"], ["s_store_sk"])
        if with_promo:
            pr = CpuFilter((col("p_channel_dmail") == lit("Y")) |
                           (col("p_channel_email") == lit("Y")) |
                           (col("p_channel_tv") == lit("Y")),
                           t["promotion"])
            j = _join(j, pr, ["ss_promo_sk"], ["p_promo_sk"])
        j = _join(_join(_join(j, t["customer"], ["ss_customer_sk"],
                              ["c_customer_sk"]),
                        ca, ["c_current_addr_sk"], ["ca_address_sk"]),
                  it, ["ss_item_sk"], ["i_item_sk"])
        return CpuProject(
            [lit(1).alias(f"_k{tag}"), col(tag)],
            CpuAggregate(
                [], [Sum(col("ss_ext_sales_price")).alias(tag)], j))
    promo = branch(True, "promotions")
    total = branch(False, "total")
    j = _join(promo, total, ["_kpromotions"], ["_ktotal"])
    out = CpuProject(
        [col("promotions"), col("total"),
         (col("promotions") / col("total") * lit(100.0)).alias("ratio")],
        j)
    return CpuLimit(100, CpuSort(
        [asc(col("promotions")), asc(col("total"))], out))


def q62(t, run):
    """Reference q62: web shipping-lag buckets by warehouse prefix /
    ship mode / site."""
    dd = CpuFilter(_between(col("d_month_seq"), lit(24), lit(35)),
                   t["date_dim"])
    j = _join(_join(_join(_join(
        dd, t["web_sales"], ["d_date_sk"], ["ws_ship_date_sk"]),
        t["warehouse"], ["ws_warehouse_sk"], ["w_warehouse_sk"]),
        t["ship_mode"], ["ws_ship_mode_sk"], ["sm_ship_mode_sk"]),
        t["web_site"], ["ws_web_site_sk"], ["web_site_sk"])
    j = CpuProject(
        [_Substring(col("w_warehouse_name"), lit(1),
                    lit(20)).alias("wh_prefix"),
         col("sm_type"), col("web_name"), col("ws_ship_date_sk"),
         col("ws_sold_date_sk")], j)
    diff = col("ws_ship_date_sk") - col("ws_sold_date_sk")
    agg = CpuAggregate(
        [col("wh_prefix"), col("sm_type"), col("web_name")],
        _lag_buckets(diff), j)
    return CpuLimit(100, CpuSort(
        [asc(col("wh_prefix")), asc(col("sm_type")),
         asc(col("web_name"))], agg))


def q63(t, run):
    """Reference q63: manager monthly sales vs their cross-month
    average (window avg expressed as an aggregate re-join — identical
    semantics)."""
    dd = CpuFilter(_between(col("d_month_seq"), lit(24), lit(35)),
                   t["date_dim"])
    it = CpuFilter(
        (InSet(col("i_category"), ("Books", "Electronics", "Home")) &
         InSet(col("i_class"), tuple(f"class{i:02d}" for i in
                                     range(8)))) |
        (InSet(col("i_category"), ("Women", "Music", "Shoes")) &
         InSet(col("i_class"), tuple(f"class{i:02d}" for i in
                                     range(8, 16)))), t["item"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        it, ["ss_item_sk"], ["i_item_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"])
    monthly = CpuAggregate(
        [col("i_manager_id"), col("d_moy")],
        [Sum(col("ss_sales_price")).alias("sum_sales")], j)
    avg = CpuProject(
        [col("i_manager_id").alias("_mgr"),
         col("avg_monthly_sales")],
        CpuAggregate(
            [col("i_manager_id")],
            [Average(col("sum_sales")).alias("avg_monthly_sales")],
            monthly))
    out = _join(monthly, avg, ["i_manager_id"], ["_mgr"])
    dev = (col("sum_sales") - col("avg_monthly_sales"))
    absdev = If(dev < lit(0.0), lit(0.0) - dev, dev)
    out = CpuFilter(
        If(col("avg_monthly_sales") > lit(0.0),
           absdev / col("avg_monthly_sales"),
           _Lit(None, _T.FLOAT64)) > lit(0.1), out)
    out = CpuProject([col("i_manager_id"), col("sum_sales"),
                      col("avg_monthly_sales")], out)
    return CpuLimit(100, CpuSort(
        [asc(col("i_manager_id")), asc(col("avg_monthly_sales")),
         asc(col("sum_sales"))], out))


def q69(t, run):
    """Reference q69: demographics of store-only shoppers in a quarter
    (EXISTS store AND NOT EXISTS web/catalog as semi/anti joins)."""
    ca = CpuFilter(InSet(col("ca_state"), ("GA", "NY", "TX")),
                   t["customer_address"])
    c = _join(t["customer"], ca, ["c_current_addr_sk"],
              ["ca_address_sk"])
    dd = CpuFilter((col("d_year") == lit(2001)) &
                   _between(col("d_moy"), lit(4), lit(6)),
                   t["date_dim"])
    ss = _join(dd, t["store_sales"], ["d_date_sk"],
               ["ss_sold_date_sk"])
    ws = _join(CpuProject([col("d_date_sk").alias("dw_sk")], dd),
               t["web_sales"], ["dw_sk"], ["ws_sold_date_sk"])
    cs = _join(CpuProject([col("d_date_sk").alias("dc_sk")], dd),
               t["catalog_sales"], ["dc_sk"], ["cs_sold_date_sk"])
    c = _join(c, ss, ["c_customer_sk"], ["ss_customer_sk"],
              jt=J.LEFT_SEMI)
    c = _join(c, ws, ["c_customer_sk"], ["ws_bill_customer_sk"],
              jt=J.LEFT_ANTI)
    c = _join(c, cs, ["c_customer_sk"], ["cs_ship_customer_sk"],
              jt=J.LEFT_ANTI)
    j = _join(c, t["customer_demographics"], ["c_current_cdemo_sk"],
              ["cd_demo_sk"])
    agg = CpuAggregate(
        [col("cd_gender"), col("cd_marital_status"),
         col("cd_education_status"), col("cd_purchase_estimate"),
         col("cd_credit_rating")],
        [Count(None).alias("cnt1")], j)
    out = CpuProject(
        [col("cd_gender"), col("cd_marital_status"),
         col("cd_education_status"), col("cnt1"),
         col("cd_purchase_estimate"), col("cnt1").alias("cnt2"),
         col("cd_credit_rating"), col("cnt1").alias("cnt3")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("cd_gender")), asc(col("cd_marital_status")),
         asc(col("cd_education_status")),
         asc(col("cd_purchase_estimate")),
         asc(col("cd_credit_rating"))], out))


def q79(t, run):
    """Reference q79: Monday coupon/profit per ticket for large
    stores."""
    dd = CpuFilter((col("d_dow") == lit(1)) &
                   InSet(col("d_year"), (1999, 2000, 2001)),
                   t["date_dim"])
    hd = CpuFilter((col("hd_dep_count") == lit(6)) |
                   (col("hd_vehicle_count") > lit(2)),
                   t["household_demographics"])
    st = CpuFilter(_between(col("s_number_employees"),
                            lit(200), lit(295)), t["store"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"]),
        hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    ms = CpuAggregate(
        [col("ss_ticket_number"), col("ss_customer_sk"),
         col("ss_addr_sk"), col("s_city")],
        [Sum(col("ss_coupon_amt")).alias("amt"),
         Sum(col("ss_net_profit")).alias("profit")], j)
    out = _join(ms, t["customer"], ["ss_customer_sk"],
                ["c_customer_sk"])
    out = CpuProject(
        [col("c_last_name"), col("c_first_name"),
         _Substring(col("s_city"), lit(1), lit(30)).alias("city30"),
         col("ss_ticket_number"), col("amt"), col("profit")], out)
    return CpuLimit(100, CpuSort(
        [asc(col("c_last_name")), asc(col("c_first_name")),
         asc(col("city30")), asc(col("profit"))], out))


def _q88_slot(t, h, half, tag):
    """one time-slot count(*) block (reference q88 s1..s8)."""
    td = CpuFilter((col("t_hour") == lit(h)) &
                   ((col("t_minute") < lit(30)) if half == 0 else
                    (col("t_minute") >= lit(30))), t["time_dim"])
    hd = CpuFilter(
        ((col("hd_dep_count") == lit(4)) &
         (col("hd_vehicle_count") <= lit(6))) |
        ((col("hd_dep_count") == lit(2)) &
         (col("hd_vehicle_count") <= lit(4))) |
        ((col("hd_dep_count") == lit(0)) &
         (col("hd_vehicle_count") <= lit(2))),
        t["household_demographics"])
    st = CpuFilter(col("s_store_name") == lit("ese"), t["store"])
    j = _join(_join(_join(
        td, t["store_sales"], ["t_time_sk"], ["ss_sold_time_sk"]),
        hd, ["ss_hdemo_sk"], ["hd_demo_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"])
    return CpuProject(
        [lit(1).alias(f"_k{tag}"), col(tag)],
        CpuAggregate([], [Count(None).alias(tag)], j))


def q88(t, run):
    """Reference q88: eight half-hour slot counts cross-joined."""
    slots = [("h8_30", 8, 1), ("h9", 9, 0), ("h9_30", 9, 1),
             ("h10", 10, 0), ("h10_30", 10, 1), ("h11", 11, 0),
             ("h11_30", 11, 1), ("h12", 12, 0)]
    blocks = [_q88_slot(t, h, half, tag) for tag, h, half in slots]
    out = blocks[0]
    prev_tag = slots[0][0]
    for b, (tag, _, _) in zip(blocks[1:], slots[1:]):
        out = _join(out, b, [f"_k{prev_tag}"], [f"_k{tag}"])
        prev_tag = tag
    return CpuProject([col(tag) for tag, _, _ in slots], out)


def q90(t, run):
    """Reference q90: am/pm web sales ratio for a dependent-count
    band."""
    def half(h_lo, h_hi, tag):
        td = CpuFilter(_between(col("t_hour"), lit(h_lo), lit(h_hi)),
                       t["time_dim"])
        hd = CpuFilter(col("hd_dep_count") == lit(6),
                       t["household_demographics"])
        wp = CpuFilter(_between(col("wp_char_count"),
                                lit(5000), lit(5200)), t["web_page"])
        j = _join(_join(_join(
            td, t["web_sales"], ["t_time_sk"], ["ws_sold_time_sk"]),
            hd, ["ws_ship_hdemo_sk"], ["hd_demo_sk"]),
            wp, ["ws_web_page_sk"], ["wp_web_page_sk"])
        return CpuProject(
            [lit(1).alias(f"_k{tag}"), col(tag)],
            CpuAggregate([], [Count(None).alias(tag)], j))
    am = half(8, 9, "amc")
    pm = half(19, 20, "pmc")
    j = _join(am, pm, ["_kamc"], ["_kpmc"])
    out = CpuProject(
        [(col("amc") / col("pmc")).alias("am_pm_ratio")], j)
    return CpuLimit(100, CpuSort([asc(col("am_pm_ratio"))], out))


def q93(t, run):
    """Reference q93: actual sales net of returns for one reason."""
    r = CpuFilter(col("r_reason_desc") == lit("reason 1"), t["reason"])
    j = _join(t["store_sales"], _join(
        t["store_returns"], r, ["sr_reason_sk"], ["r_reason_sk"]),
        ["ss_item_sk", "ss_ticket_number"],
        ["sr_item_sk", "sr_ticket_number"], jt=J.LEFT_OUTER)
    act = If(IsNotNull(col("sr_ticket_number")),
             (col("ss_quantity") - col("sr_return_quantity")) *
             col("ss_sales_price"),
             col("ss_quantity") * col("ss_sales_price"))
    pre = CpuProject([col("ss_customer_sk"), act.alias("act_sales")], j)
    agg = CpuAggregate([col("ss_customer_sk")],
                       [Sum(col("act_sales")).alias("sumsales")], pre)
    return CpuLimit(100, CpuSort(
        [asc(col("sumsales")), asc(col("ss_customer_sk"))], agg))


def q98(t, run):
    """Reference q98: store item/class revenue ratio (no limit)."""
    return _item_class_revenue(t, t["store_sales"], "ss_sold_date_sk",
                               "ss_item_sk", "ss_ext_sales_price",
                               limit=None)


def q99(t, run):
    """Reference q99: catalog shipping-lag buckets by warehouse prefix /
    ship mode / call center."""
    dd = CpuFilter(_between(col("d_month_seq"), lit(24), lit(35)),
                   t["date_dim"])
    j = _join(_join(_join(_join(
        dd, t["catalog_sales"], ["d_date_sk"], ["cs_ship_date_sk"]),
        t["warehouse"], ["cs_warehouse_sk"], ["w_warehouse_sk"]),
        t["ship_mode"], ["cs_ship_mode_sk"], ["sm_ship_mode_sk"]),
        t["call_center"], ["cs_call_center_sk"], ["cc_call_center_sk"])
    j = CpuProject(
        [_Substring(col("w_warehouse_name"), lit(1),
                    lit(20)).alias("wh_prefix"),
         col("sm_type"), col("cc_name"), col("cs_ship_date_sk"),
         col("cs_sold_date_sk")], j)
    diff = col("cs_ship_date_sk") - col("cs_sold_date_sk")
    agg = CpuAggregate(
        [col("wh_prefix"), col("sm_type"), col("cc_name")],
        _lag_buckets(diff), j)
    return CpuLimit(100, CpuSort(
        [asc(col("wh_prefix")), asc(col("sm_type")),
         asc(col("cc_name"))], agg))


QUERIES.update({
    "q34": q34, "q46": q46, "q50": q50, "q61": q61, "q62": q62,
    "q63": q63, "q69": q69, "q79": q79, "q88": q88, "q90": q90,
    "q93": q93, "q98": q98, "q99": q99,
})


def _item_class_revenue(t, sales, date_key, item_key, val,
                        limit=100):
    """q12/q20/q98 family: item revenue + class revenue ratio over one
    30-day window (window sum as aggregate re-join)."""
    dd = CpuFilter(_between(col("d_date"), _date(1999, 2, 22),
                            _date(1999, 3, 24)), t["date_dim"])
    it = CpuFilter(InSet(col("i_category"),
                         ("Sports", "Books", "Home")), t["item"])
    j = _join(_join(dd, sales, ["d_date_sk"], [date_key]),
              it, [item_key], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("i_category"),
         col("i_class"), col("i_current_price")],
        [Sum(col(val)).alias("itemrevenue")], j)
    cls = CpuProject(
        [col("i_class").alias("_cls"), col("classrev")],
        CpuAggregate([col("i_class")],
                     [Sum(col("itemrevenue")).alias("classrev")], agg))
    out = _join(agg, cls, ["i_class"], ["_cls"])
    out = CpuProject(
        [col("i_item_id"), col("i_item_desc"), col("i_category"),
         col("i_class"), col("i_current_price"), col("itemrevenue"),
         (col("itemrevenue") * lit(100.0) /
          col("classrev")).alias("revenueratio")], out)
    srt = CpuSort(
        [asc(col("i_category")), asc(col("i_class")),
         asc(col("i_item_id")), asc(col("i_item_desc")),
         asc(col("revenueratio"))], out)
    return srt if limit is None else CpuLimit(limit, srt)


def q12(t, run):
    """Reference q12: web item/class revenue ratio."""
    return _item_class_revenue(t, t["web_sales"], "ws_sold_date_sk",
                               "ws_item_sk", "ws_ext_sales_price")


def q20(t, run):
    """Reference q20: catalog item/class revenue ratio."""
    return _item_class_revenue(t, t["catalog_sales"],
                               "cs_sold_date_sk", "cs_item_sk",
                               "cs_ext_sales_price")


def q82(t, run):
    """Reference q82: in-stock store items in a price band."""
    it = CpuFilter(
        _between(col("i_current_price"), lit(30.0), lit(95.0)) &
        InSet(col("i_manufact_id"), tuple(range(20, 61))), t["item"])
    dd = CpuFilter(_between(col("d_date"), _date(2000, 5, 25),
                            _date(2000, 11, 25)), t["date_dim"])
    inv = CpuFilter(_between(col("inv_quantity_on_hand"),
                             lit(100), lit(500)), t["inventory"])
    j = _join(_join(_join(it, inv, ["i_item_sk"], ["inv_item_sk"]),
                    dd, ["inv_date_sk"], ["d_date_sk"]),
              t["store_sales"], ["i_item_sk"], ["ss_item_sk"])
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("i_current_price")],
        [Count(None).alias("_c")], j)
    out = CpuProject([col("i_item_id"), col("i_item_desc"),
                      col("i_current_price")], agg)
    return CpuLimit(100, CpuSort([asc(col("i_item_id"))], out))


def q92(t, run):
    """Reference q92: web discounts exceeding 1.3x the per-item window
    average (correlated subquery as aggregate re-join)."""
    dd = CpuFilter(_between(col("d_date"), _date(2000, 1, 27),
                            _date(2000, 4, 26)), t["date_dim"])
    ws = _join(dd, t["web_sales"], ["d_date_sk"], ["ws_sold_date_sk"])
    it = CpuFilter(InSet(col("i_manufact_id"),
                         tuple(range(30, 40))), t["item"])
    j = _join(ws, it, ["ws_item_sk"], ["i_item_sk"])
    avg = CpuProject(
        [col("ws_item_sk").alias("_isk"),
         (col("a") * lit(1.3)).alias("threshold")],
        CpuAggregate(
            [col("ws_item_sk")],
            [Average(col("ws_ext_discount_amt")).alias("a")], ws))
    out = _join(j, avg, ["ws_item_sk"], ["_isk"])
    out = CpuFilter(col("ws_ext_discount_amt") > col("threshold"), out)
    agg = CpuAggregate(
        [], [Sum(col("ws_ext_discount_amt")).alias("excess")], out)
    return CpuLimit(100, agg)


def q94(t, run):
    """Reference q94: multi-warehouse never-returned web orders (EXISTS
    as a >1-warehouse-order semi join, NOT EXISTS as anti join)."""
    dd = CpuFilter(_between(col("d_date"), _date(1999, 2, 1),
                            _date(1999, 4, 2)), t["date_dim"])
    ca = CpuFilter(col("ca_state") == lit("IL"),
                   t["customer_address"])
    site = CpuFilter(col("web_company_name") == lit("pri"),
                     t["web_site"])
    ws1 = _join(_join(_join(
        dd, t["web_sales"], ["d_date_sk"], ["ws_ship_date_sk"]),
        ca, ["ws_ship_addr_sk"], ["ca_address_sk"]),
        site, ["ws_web_site_sk"], ["web_site_sk"])
    multi_wh = CpuFilter(
        col("nwh") > lit(1),
        CpuAggregate(
            [col("morder")], [Count(None).alias("nwh")],
            CpuAggregate(
                [col("ws_order_number").alias("morder"),
                 col("ws_warehouse_sk")],
                [Count(None).alias("_c")], t["web_sales"])))
    ws1 = _join(ws1, multi_wh, ["ws_order_number"], ["morder"],
                jt=J.LEFT_SEMI)
    ws1 = _join(ws1, t["web_returns"], ["ws_order_number"],
                ["wr_order_number"], jt=J.LEFT_ANTI)
    dist = CpuAggregate(
        [], [Count(col("dorder")).alias("order_count")],
        CpuAggregate([col("ws_order_number").alias("dorder")],
                     [Count(None).alias("_d")], ws1))
    sums = CpuAggregate(
        [], [Sum(col("ws_ext_ship_cost")).alias("total_ship_cost"),
             Sum(col("ws_net_profit")).alias("total_net_profit")], ws1)
    j = _join(CpuProject([lit(1).alias("_ka"), col("order_count")],
                         dist),
              CpuProject([lit(1).alias("_kb"), col("total_ship_cost"),
                          col("total_net_profit")], sums),
              ["_ka"], ["_kb"])
    return CpuLimit(100, CpuProject(
        [col("order_count"), col("total_ship_cost"),
         col("total_net_profit")], j))


def _distinct_channel_triples(t, sales, date_key, cust_key):
    dd = CpuFilter(_between(col("d_month_seq"), lit(24), lit(35)),
                   t["date_dim"])
    j = _join(_join(dd, sales, ["d_date_sk"], [date_key]),
              t["customer"], [cust_key], ["c_customer_sk"])
    return CpuAggregate(
        [col("c_last_name"), col("c_first_name"), col("d_date")],
        [Count(None).alias("_n")], j)


def q38(t, run):
    """Reference q38: customers active in ALL three channels
    (INTERSECT as successive semi joins on the distinct triples)."""
    ss = _distinct_channel_triples(t, t["store_sales"],
                                   "ss_sold_date_sk", "ss_customer_sk")
    cs = CpuProject(
        [col("c_last_name").alias("cl"), col("c_first_name").alias("cf"),
         col("d_date").alias("cd")],
        _distinct_channel_triples(t, t["catalog_sales"],
                                  "cs_sold_date_sk",
                                  "cs_bill_customer_sk"))
    ws = CpuProject(
        [col("c_last_name").alias("wl"), col("c_first_name").alias("wf"),
         col("d_date").alias("wd")],
        _distinct_channel_triples(t, t["web_sales"],
                                  "ws_sold_date_sk",
                                  "ws_bill_customer_sk"))
    both = _join(ss, cs, ["c_last_name", "c_first_name", "d_date"],
                 ["cl", "cf", "cd"], jt=J.LEFT_SEMI)
    allc = _join(both, ws, ["c_last_name", "c_first_name", "d_date"],
                 ["wl", "wf", "wd"], jt=J.LEFT_SEMI)
    return CpuLimit(100, CpuAggregate(
        [], [Count(None).alias("cnt")], allc))


def q87(t, run):
    """Reference q87: store-only customer/date triples (EXCEPT as
    successive anti joins)."""
    ss = _distinct_channel_triples(t, t["store_sales"],
                                   "ss_sold_date_sk", "ss_customer_sk")
    cs = CpuProject(
        [col("c_last_name").alias("cl"), col("c_first_name").alias("cf"),
         col("d_date").alias("cd")],
        _distinct_channel_triples(t, t["catalog_sales"],
                                  "cs_sold_date_sk",
                                  "cs_bill_customer_sk"))
    ws = CpuProject(
        [col("c_last_name").alias("wl"), col("c_first_name").alias("wf"),
         col("d_date").alias("wd")],
        _distinct_channel_triples(t, t["web_sales"],
                                  "ws_sold_date_sk",
                                  "ws_bill_customer_sk"))
    no_cs = _join(ss, cs, ["c_last_name", "c_first_name", "d_date"],
                  ["cl", "cf", "cd"], jt=J.LEFT_ANTI)
    only_ss = _join(no_cs, ws, ["c_last_name", "c_first_name",
                                "d_date"],
                    ["wl", "wf", "wd"], jt=J.LEFT_ANTI)
    return CpuAggregate([], [Count(None).alias("cnt")], only_ss)


QUERIES.update({
    "q12": q12, "q20": q20, "q82": q82, "q92": q92,
    "q94": q94, "q38": q38, "q87": q87,
})


def q9(t, run):
    """Reference q9: five quantity-band CASE buckets from scalar
    subqueries (run() materializes each, the CASE picks avg discount vs
    avg net_paid by count threshold; thresholds scaled to the
    generator's volumes)."""
    bands = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    exprs = []
    for i, (lo, hi) in enumerate(bands, start=1):
        stats = run(CpuAggregate(
            [], [Count(None).alias("c"),
                 Average(col("ss_ext_discount_amt")).alias("ad"),
                 Average(col("ss_net_paid")).alias("ap")],
            CpuFilter(_between(col("ss_quantity"), lit(lo), lit(hi)),
                      t["store_sales"])))
        cnt = int(stats["c"].iloc[0])
        val = float(stats["ad"].iloc[0] if cnt > 1200
                    else stats["ap"].iloc[0])
        exprs.append(lit(val).alias(f"bucket{i}"))
    one = CpuFilter(col("r_reason_sk") == lit(1), t["reason"])
    return CpuProject(exprs, one)


def q41(t, run):
    """Reference q41: distinct product names whose manufacturer also
    makes items in the listed color/unit/size combinations."""
    arms = (
        (InSet(col("i_category"), ("Women",)) &
         InSet(col("i_color"), ("powder", "khaki")) &
         InSet(col("i_units"), ("Ounce", "Oz")) &
         InSet(col("i_size"), ("medium", "extra large"))) |
        (InSet(col("i_category"), ("Music",)) &
         InSet(col("i_color"), ("floral", "deep")) &
         InSet(col("i_units"), ("N/A", "Dozen")) &
         InSet(col("i_size"), ("petite", "large"))) |
        (InSet(col("i_category"), ("Shoes",)) &
         InSet(col("i_color"), ("light", "cornflower")) &
         InSet(col("i_units"), ("Box", "Pound")) &
         InSet(col("i_size"), ("medium", "extra large"))) |
        (InSet(col("i_category"), ("Books",)) &
         InSet(col("i_color"), ("midnight", "snow")) &
         InSet(col("i_units"), ("Ounce", "Oz")) &
         InSet(col("i_size"), ("petite", "large"))))
    match_manufact = CpuProject(
        [col("i_manufact").alias("_mf")],
        CpuAggregate([col("i_manufact")], [Count(None).alias("_c")],
                     CpuFilter(arms, t["item"])))
    i1 = CpuFilter(_between(col("i_manufact_id"), lit(1), lit(40)),
                   t["item"])
    j = _join(i1, match_manufact, ["i_manufact"], ["_mf"],
              jt=J.LEFT_SEMI)
    dist = CpuAggregate([col("i_product_name")],
                        [Count(None).alias("_c")], j)
    out = CpuProject([col("i_product_name")], dist)
    return CpuLimit(100, CpuSort([asc(col("i_product_name"))], out))


def q16(t, run):
    """Reference q16: multi-warehouse never-returned catalog orders for
    one county/state window (EXISTS/NOT EXISTS as semi/anti joins)."""
    dd = CpuFilter(_between(col("d_date"), _date(2002, 2, 1),
                            _date(2002, 4, 2)), t["date_dim"])
    ca = CpuFilter(col("ca_state") == lit("GA"),
                   t["customer_address"])
    cc = CpuFilter(InSet(col("cc_county"), ("Williamson County",)),
                   t["call_center"])
    cs1 = _join(_join(_join(
        dd, t["catalog_sales"], ["d_date_sk"], ["cs_ship_date_sk"]),
        ca, ["cs_ship_addr_sk"], ["ca_address_sk"]),
        cc, ["cs_call_center_sk"], ["cc_call_center_sk"])
    multi_wh = CpuFilter(
        col("nwh") > lit(1),
        CpuAggregate(
            [col("morder")], [Count(None).alias("nwh")],
            CpuAggregate(
                [col("cs_order_number").alias("morder"),
                 col("cs_warehouse_sk")],
                [Count(None).alias("_c")], t["catalog_sales"])))
    cs1 = _join(cs1, multi_wh, ["cs_order_number"], ["morder"],
                jt=J.LEFT_SEMI)
    cs1 = _join(cs1, t["catalog_returns"], ["cs_order_number"],
                ["cr_order_number"], jt=J.LEFT_ANTI)
    dist = CpuAggregate(
        [], [Count(col("dorder")).alias("order_count")],
        CpuAggregate([col("cs_order_number").alias("dorder")],
                     [Count(None).alias("_d")], cs1))
    sums = CpuAggregate(
        [], [Sum(col("cs_ext_ship_cost")).alias("total_ship_cost"),
             Sum(col("cs_net_profit")).alias("total_net_profit")], cs1)
    j = _join(CpuProject([lit(1).alias("_ka"), col("order_count")],
                         dist),
              CpuProject([lit(1).alias("_kb"), col("total_ship_cost"),
                          col("total_net_profit")], sums),
              ["_ka"], ["_kb"])
    return CpuLimit(100, CpuProject(
        [col("order_count"), col("total_ship_cost"),
         col("total_net_profit")], j))


QUERIES.update({"q9": q9, "q41": q41, "q16": q16})


def q21(t, run):
    """Reference q21: warehouse inventory before/after one cutover date
    for a price band, keeping ratio-bounded rows."""
    it = CpuFilter(_between(col("i_current_price"),
                            lit(10.0), lit(60.0)), t["item"])
    dd = CpuFilter(_between(col("d_date"), _date(2000, 1, 1),
                            _date(2000, 6, 30)), t["date_dim"])
    j = _join(_join(_join(
        dd, t["inventory"], ["d_date_sk"], ["inv_date_sk"]),
        t["warehouse"], ["inv_warehouse_sk"], ["w_warehouse_sk"]),
        it, ["inv_item_sk"], ["i_item_sk"])
    agg = CpuAggregate(
        [col("w_warehouse_name"), col("i_item_id")],
        [Sum(If(col("d_date") < _date(2000, 3, 11),
                col("inv_quantity_on_hand"),
                lit(0))).alias("inv_before"),
         Sum(If(col("d_date") >= _date(2000, 3, 11),
                col("inv_quantity_on_hand"),
                lit(0))).alias("inv_after")], j)
    ratio = If(col("inv_before") > lit(0),
               col("inv_after") / col("inv_before"),
               _Lit(None, _T.FLOAT64))
    # reference band is 2/3..3/2; the sparse synthetic inventory
    # needs a wider one to keep rows
    out = CpuFilter((ratio >= lit(0.1)) & (ratio <= lit(10.0)), agg)
    return CpuLimit(100, CpuSort(
        [asc(col("w_warehouse_name")), asc(col("i_item_id"))], out))


QUERIES.update({"q21": q21})


# ---------------------------------------------------------------------------
# round-3 continued: faithful upgrades over the extended generator
# (d_week_seq, t_meal_time, income_band, hd_income_band_sk, nullable
# channel fks).  Reference text: TpcdsLikeSpark.scala:708+.

def _day_sum(val: str, name: str, alias: str):
    """sum(case when d_day_name='<name>' then <val> else null end)"""
    return Sum(If(col("d_day_name") == lit(name), col(val),
                  _Lit(None, _T.FLOAT64))).alias(alias)


_DAYS = [("Sunday", "sun"), ("Monday", "mon"), ("Tuesday", "tue"),
         ("Wednesday", "wed"), ("Thursday", "thu"), ("Friday", "fri"),
         ("Saturday", "sat")]


def q2(t, run):
    """Reference q2: web+catalog weekly day-of-week sales, year-over-
    year ratio on week_seq1 = week_seq2 - 53."""
    wscs = CpuUnion(
        CpuProject([col("ws_sold_date_sk").alias("sold_date_sk"),
                    col("ws_ext_sales_price").alias("sales_price")],
                   t["web_sales"]),
        CpuProject([col("cs_sold_date_sk").alias("sold_date_sk"),
                    col("cs_ext_sales_price").alias("sales_price")],
                   t["catalog_sales"]))
    j = _join(t["date_dim"], wscs, ["d_date_sk"], ["sold_date_sk"])
    wswscs = CpuAggregate(
        [col("d_week_seq")],
        [_day_sum("sales_price", d, f"{p}_sales") for d, p in _DAYS], j)

    def year_slice(year, tag):
        wk = CpuProject([col("d_week_seq").alias(f"{tag}_wk")],
                        CpuFilter(col("d_year") == lit(year),
                                  t["date_dim"]))
        named = CpuProject(
            [col("d_week_seq").alias(f"d_week_seq{tag}")] +
            [col(f"{p}_sales").alias(f"{p}_sales{tag}")
             for _, p in _DAYS], wswscs)
        return _join(named, wk, [f"d_week_seq{tag}"], [f"{tag}_wk"])

    y = year_slice(2001, "1")
    z = CpuProject(
        [(col("d_week_seq2") - lit(53)).alias("z_key")] +
        [col(f"{p}_sales2") for _, p in _DAYS], year_slice(2002, "2"))
    j2 = _join(y, z, ["d_week_seq1"], ["z_key"])
    out = CpuProject(
        [col("d_week_seq1")] +
        [Round(col(f"{p}_sales1") / col(f"{p}_sales2"), 2
               ).alias(f"r_{p}") for _, p in _DAYS], j2)
    return CpuSort([asc(col("d_week_seq1"))], out)


def q59(t, run):
    """Reference q59: store weekly day-of-week sales, consecutive
    12-month windows ratio (week_seq1 = week_seq2 - 52)."""
    j = _join(t["date_dim"], t["store_sales"],
              ["d_date_sk"], ["ss_sold_date_sk"])
    wss = CpuAggregate(
        [col("d_week_seq"), col("ss_store_sk")],
        [_day_sum("ss_sales_price", d, f"{p}_sales")
         for d, p in _DAYS], j)

    def window(mlo, mhi, tag, days):
        # reference month_seq window 1212..1212+11 stands in as the
        # generator's month_seq domain [0, 59]
        wk = CpuProject(
            [col("d_week_seq").alias(f"{tag}_wk")],
            CpuFilter(_between(col("d_month_seq"), lit(mlo), lit(mhi)),
                      t["date_dim"]))
        named = CpuProject(
            [col("d_week_seq").alias(f"d_week_seq{tag}"),
             col("ss_store_sk").alias(f"store_sk{tag}")] +
            [col(f"{p}_sales").alias(f"{p}_sales{tag}") for p in days],
            wss)
        st = _join(named, t["store"], [f"store_sk{tag}"], ["s_store_sk"])
        keep = ([col(f"d_week_seq{tag}"),
                 col("s_store_name").alias(f"s_store_name{tag}"),
                 col("s_store_id").alias(f"s_store_id{tag}")] +
                [col(f"{p}_sales{tag}") for p in days])
        return _join(CpuProject(keep, st), wk,
                     [f"d_week_seq{tag}"], [f"{tag}_wk"])

    days1 = [p for _, p in _DAYS]
    y = window(12, 23, "1", days1)
    x = CpuProject(
        [(col("d_week_seq2") - lit(52)).alias("x_key"),
         col("s_store_id2")] +
        [col(f"{p}_sales2") for p in days1],
        window(24, 35, "2", days1))
    j2 = _join(y, x, ["d_week_seq1", "s_store_id1"],
               ["x_key", "s_store_id2"])
    out = CpuProject(
        [col("s_store_name1"), col("s_store_id1"), col("d_week_seq1")] +
        [(col(f"{p}_sales1") / col(f"{p}_sales2")).alias(f"r_{p}")
         for p in days1], j2)
    return CpuLimit(100, CpuSort(
        [asc(col("s_store_name1")), asc(col("s_store_id1")),
         asc(col("d_week_seq1"))], out))


def _q76_channel(t, sales, null_col, date_key, item_key, price, chan):
    f = CpuFilter(IsNull(col(null_col)), sales)
    j = _join(_join(f, t["item"], [item_key], ["i_item_sk"]),
              t["date_dim"], [date_key], ["d_date_sk"])
    return CpuProject(
        [lit(chan).alias("channel"), col(null_col).alias("col_name"),
         col("d_year"), col("d_qoy"), col("i_category"),
         col(price).alias("ext_sales_price")], j)


def q76(t, run):
    """Reference q76: sales rows with a NULL channel fk, per channel."""
    u = CpuUnion(
        _q76_channel(t, t["store_sales"], "ss_store_sk",
                     "ss_sold_date_sk", "ss_item_sk",
                     "ss_ext_sales_price", "store"),
        _q76_channel(t, t["web_sales"], "ws_ship_customer_sk",
                     "ws_sold_date_sk", "ws_item_sk",
                     "ws_ext_sales_price", "web"),
        _q76_channel(t, t["catalog_sales"], "cs_ship_addr_sk",
                     "cs_sold_date_sk", "cs_item_sk",
                     "cs_ext_sales_price", "catalog"))
    agg = CpuAggregate(
        [col("channel"), col("col_name"), col("d_year"), col("d_qoy"),
         col("i_category")],
        [Count(None).alias("sales_cnt"),
         Sum(col("ext_sales_price")).alias("sales_amt")], u)
    return CpuLimit(100, CpuSort(
        [asc(col("channel")), asc(col("col_name")), asc(col("d_year")),
         asc(col("d_qoy")), asc(col("i_category"))], agg))


def q84(t, run):
    """Reference q84: customers in one city within an income band who
    returned something."""
    ca = CpuFilter(col("ca_city") == lit("Edgewood"),
                   t["customer_address"])
    ib = CpuFilter((col("ib_lower_bound") >= lit(38128)) &
                   (col("ib_upper_bound") <= lit(38128 + 50000)),
                   t["income_band"])
    j = _join(t["customer"], ca, ["c_current_addr_sk"],
              ["ca_address_sk"])
    j = _join(j, t["customer_demographics"],
              ["c_current_cdemo_sk"], ["cd_demo_sk"])
    j = _join(j, t["household_demographics"],
              ["c_current_hdemo_sk"], ["hd_demo_sk"])
    j = _join(j, ib, ["hd_income_band_sk"], ["ib_income_band_sk"])
    j = _join(j, t["store_returns"], ["cd_demo_sk"], ["sr_cdemo_sk"])
    out = CpuProject(
        [col("c_customer_id").alias("customer_id"),
         ConcatStrings((Coalesce((col("c_last_name"), lit(""))),
                        lit(", "),
                        Coalesce((col("c_first_name"), lit(""))))
         ).alias("customername")], j)
    return CpuLimit(100, CpuSort([asc(col("customer_id"))], out))


def q91(t, run):
    """Reference q91: call-center catalog returns loss for one month by
    demographic slice."""
    # reference window is 1998-11; the full year stands in for the
    # sparse synthetic returns table
    dd = CpuFilter(col("d_year") == lit(1998), t["date_dim"])
    cd = CpuFilter(
        ((col("cd_marital_status") == lit("M")) &
         (col("cd_education_status") == lit("Unknown"))) |
        ((col("cd_marital_status") == lit("W")) &
         (col("cd_education_status") == lit("Advanced Degree"))),
        t["customer_demographics"])
    hd = CpuFilter(Like(col("hd_buy_potential"), lit("Unknown%")),
                   t["household_demographics"])
    ca = CpuFilter(col("ca_gmt_offset") == lit(-7.0),
                   t["customer_address"])
    j = _join(t["call_center"], t["catalog_returns"],
              ["cc_call_center_sk"], ["cr_call_center_sk"])
    j = _join(j, dd, ["cr_returned_date_sk"], ["d_date_sk"])
    j = _join(j, t["customer"], ["cr_returning_customer_sk"],
              ["c_customer_sk"])
    j = _join(j, cd, ["c_current_cdemo_sk"], ["cd_demo_sk"])
    j = _join(j, hd, ["c_current_hdemo_sk"], ["hd_demo_sk"])
    j = _join(j, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    agg = CpuAggregate(
        [col("cc_call_center_id"), col("cc_name"), col("cc_manager"),
         col("cd_marital_status"), col("cd_education_status")],
        [Sum(col("cr_net_loss")).alias("returns_loss")], j)
    out = CpuProject(
        [col("cc_call_center_id").alias("call_center"),
         col("cc_name").alias("call_center_name"),
         col("cc_manager").alias("manager"),
         col("returns_loss")], agg)
    return CpuSort([desc(col("returns_loss"))], out)


def q71(t, run):
    """Reference q71: one manager's brand revenue by hour/minute over
    all three channels, breakfast + dinner meal times."""
    def chan(sales, price, date_key, item_key, time_key):
        dd = CpuFilter((col("d_moy") == lit(11)) &
                       (col("d_year") == lit(1999)), t["date_dim"])
        j = _join(dd, sales, ["d_date_sk"], [date_key])
        return CpuProject(
            [col(price).alias("ext_price"),
             col(item_key).alias("sold_item_sk"),
             col(time_key).alias("time_sk")], j)

    u = CpuUnion(
        chan(t["web_sales"], "ws_ext_sales_price", "ws_sold_date_sk",
             "ws_item_sk", "ws_sold_time_sk"),
        chan(t["catalog_sales"], "cs_ext_sales_price",
             "cs_sold_date_sk", "cs_item_sk", "cs_sold_time_sk"),
        chan(t["store_sales"], "ss_ext_sales_price", "ss_sold_date_sk",
             "ss_item_sk", "ss_sold_time_sk"))
    it = CpuFilter(col("i_manager_id") == lit(1), t["item"])
    td = CpuFilter((col("t_meal_time") == lit("breakfast")) |
                   (col("t_meal_time") == lit("dinner")), t["time_dim"])
    j = _join(_join(u, it, ["sold_item_sk"], ["i_item_sk"]),
              td, ["time_sk"], ["t_time_sk"])
    agg = CpuAggregate(
        [col("i_brand"), col("i_brand_id"), col("t_hour"),
         col("t_minute")],
        [Sum(col("ext_price")).alias("ext_price")], j)
    out = CpuProject(
        [col("i_brand_id").alias("brand_id"),
         col("i_brand").alias("brand"), col("t_hour"), col("t_minute"),
         col("ext_price")], agg)
    return CpuSort([desc(col("ext_price")), asc(col("brand_id"))], out)


def q8(t, run):
    """Reference q8: store profit for stores whose zip prefix matches
    zips that are both on the campaign list and dense in preferred
    customers (INTERSECT via inner join of the two distinct sets)."""
    # reference's 400-zip campaign list stands in as its intersection
    # with the generator zip pool + three pool zips
    zips = ("10144", "10336", "10390", "10445", "10516", "10567",
            "85669", "86197", "88274")
    listed = CpuAggregate(
        [col("zip5")], [Count(None).alias("_a")],
        CpuProject([_Substring(col("ca_zip"), lit(1),
                               lit(5)).alias("zip5")],
                   CpuFilter(InSet(_Substring(col("ca_zip"), lit(1),
                                              lit(5)), zips),
                             t["customer_address"])))
    pref = _join(t["customer_address"], 
                 CpuFilter(col("c_preferred_cust_flag") == lit("Y"),
                           t["customer"]),
                 ["ca_address_sk"], ["c_current_addr_sk"])
    dense = CpuFilter(
        col("cnt") > lit(10),
        CpuAggregate([col("pzip")], [Count(None).alias("cnt")],
                     CpuProject([_Substring(col("ca_zip"), lit(1),
                                            lit(5)).alias("pzip")],
                                pref)))
    v1 = CpuProject(
        [_Substring(col("zip5"), lit(1), lit(2)).alias("zip2")],
        _join(listed, dense, ["zip5"], ["pzip"]))
    dd = CpuFilter((col("d_qoy") == lit(2)) &
                   (col("d_year") == lit(1998)), t["date_dim"])
    j = _join(_join(dd, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              t["store"], ["ss_store_sk"], ["s_store_sk"])
    j = CpuProject(
        [col("s_store_name"), col("ss_net_profit"),
         _Substring(col("s_zip"), lit(1), lit(2)).alias("szip2")], j)
    j = _join(j, CpuAggregate([col("zip2")],
                              [Count(None).alias("_b")], v1),
              ["szip2"], ["zip2"], jt=J.LEFT_SEMI)
    agg = CpuAggregate([col("s_store_name")],
                       [Sum(col("ss_net_profit")).alias("profit")], j)
    return CpuLimit(100, CpuSort([asc(col("s_store_name"))], agg))


QUERIES.update({
    "q2": q2, "q59": q59, "q76": q76, "q84": q84, "q91": q91,
    "q71": q71, "q8": q8,
})


def _year_total_slice(t, chan, year, amount, group_extra=()):
    """One year_total CTE slice (q4/q11/q74): per-customer yearly sum
    for one channel.  `amount(prefix)` builds the summed expression."""
    sales, cust_key, date_key = {
        "s": ("store_sales", "ss_customer_sk", "ss_sold_date_sk"),
        "c": ("catalog_sales", "cs_bill_customer_sk",
              "cs_sold_date_sk"),
        "w": ("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk"),
    }[chan]
    dd = CpuFilter(col("d_year") == lit(year), t["date_dim"])
    j = _join(_join(dd, t[sales], ["d_date_sk"], [date_key]),
              t["customer"], [cust_key], ["c_customer_sk"])
    groups = ["c_customer_id", "c_first_name", "c_last_name",
              "c_preferred_cust_flag", "c_birth_country", "c_login",
              "c_email_address"] + list(group_extra)
    return CpuAggregate([col(g) for g in groups],
                        [Sum(amount).alias("year_total")], j)


def _yt_named(slice_plan, tag, keep):
    """Project a year_total slice to tag-prefixed columns."""
    return CpuProject(
        [col(c).alias(f"{tag}_{c}") for c in keep] +
        [col("year_total").alias(f"{tag}_total")], slice_plan)


def q4(t, run):
    """Reference q4: customers whose catalog growth beats both store
    and web growth, across all three channels."""
    y1, y2 = 2001, 2002
    amt = {
        "s": ((col("ss_ext_list_price") - col("ss_ext_wholesale_cost")
               - col("ss_ext_discount_amt")) +
              col("ss_ext_sales_price")) / lit(2.0),
        "c": ((col("cs_ext_list_price") - col("cs_wholesale_cost")
               - col("cs_ext_discount_amt")) +
              col("cs_ext_sales_price")) / lit(2.0),
        "w": ((col("ws_ext_list_price") - col("ws_ext_discount_amt"))
              + col("ws_ext_sales_price")) / lit(2.0),
    }
    named = {}
    for ch in ("s", "c", "w"):
        keep = (["c_customer_id", "c_first_name", "c_last_name",
                 "c_preferred_cust_flag"] if ch == "s" else
                ["c_customer_id"])
        named[(ch, 1)] = _yt_named(
            _year_total_slice(t, ch, y1, amt[ch]), f"{ch}1",
            ["c_customer_id"])
        named[(ch, 2)] = _yt_named(
            _year_total_slice(t, ch, y2, amt[ch]), f"{ch}2",
            keep if ch == "s" else ["c_customer_id"])
    j = _join(named[("s", 1)], named[("s", 2)],
              ["s1_c_customer_id"], ["s2_c_customer_id"])
    for ch in ("c", "w"):
        j = _join(j, named[(ch, 1)], ["s1_c_customer_id"],
                  [f"{ch}1_c_customer_id"])
        j = _join(j, named[(ch, 2)], ["s1_c_customer_id"],
                  [f"{ch}2_c_customer_id"])

    def growth(ch):
        return If(col(f"{ch}1_total") > lit(0.0),
                  col(f"{ch}2_total") / col(f"{ch}1_total"),
                  _Lit(None, _T.FLOAT64))
    f = CpuFilter(
        (col("s1_total") > lit(0.0)) &
        (col("c1_total") > lit(0.0)) &
        (col("w1_total") > lit(0.0)) &
        (growth("c") > growth("s")) & (growth("c") > growth("w")), j)
    out = CpuProject(
        [col("s2_c_customer_id").alias("customer_id"),
         col("s2_c_first_name").alias("customer_first_name"),
         col("s2_c_last_name").alias("customer_last_name"),
         col("s2_c_preferred_cust_flag"
             ).alias("customer_preferred_cust_flag")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("customer_id")), asc(col("customer_first_name")),
         asc(col("customer_last_name")),
         asc(col("customer_preferred_cust_flag"))], out))


def q11(t, run):
    """Reference q11: customers whose web growth beats store growth
    (else-0.0 ratio semantics)."""
    amt_s = col("ss_ext_list_price") - col("ss_ext_discount_amt")
    amt_w = col("ws_ext_list_price") - col("ws_ext_discount_amt")
    y1, y2 = 2001, 2002
    named = {
        ("s", 1): _yt_named(_year_total_slice(t, "s", y1, amt_s), "s1",
                            ["c_customer_id"]),
        ("s", 2): _yt_named(_year_total_slice(t, "s", y2, amt_s), "s2",
                            ["c_customer_id", "c_first_name",
                             "c_last_name", "c_preferred_cust_flag"]),
        ("w", 1): _yt_named(_year_total_slice(t, "w", y1, amt_w), "w1",
                            ["c_customer_id"]),
        ("w", 2): _yt_named(_year_total_slice(t, "w", y2, amt_w), "w2",
                            ["c_customer_id"]),
    }
    j = _join(named[("s", 1)], named[("s", 2)],
              ["s1_c_customer_id"], ["s2_c_customer_id"])
    j = _join(j, named[("w", 1)], ["s1_c_customer_id"],
              ["w1_c_customer_id"])
    j = _join(j, named[("w", 2)], ["s1_c_customer_id"],
              ["w2_c_customer_id"])

    def growth(ch):
        return If(col(f"{ch}1_total") > lit(0.0),
                  col(f"{ch}2_total") / col(f"{ch}1_total"), lit(0.0))
    f = CpuFilter(
        (col("s1_total") > lit(0.0)) & (col("w1_total") > lit(0.0)) &
        (growth("w") > growth("s")), j)
    out = CpuProject(
        [col("s2_c_customer_id").alias("customer_id"),
         col("s2_c_first_name").alias("customer_first_name"),
         col("s2_c_last_name").alias("customer_last_name"),
         col("s2_c_preferred_cust_flag"
             ).alias("customer_preferred_cust_flag")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("customer_id")), asc(col("customer_first_name")),
         asc(col("customer_last_name")),
         asc(col("customer_preferred_cust_flag"))], out))


def q74(t, run):
    """Reference q74: q11's shape on ss/ws_net_paid, null-else ratio,
    ordered by customer_id."""
    y1, y2 = 2001, 2002
    named = {
        ("s", 1): _yt_named(
            _year_total_slice(t, "s", y1, col("ss_net_paid")), "s1",
            ["c_customer_id"]),
        ("s", 2): _yt_named(
            _year_total_slice(t, "s", y2, col("ss_net_paid")), "s2",
            ["c_customer_id", "c_first_name", "c_last_name"]),
        ("w", 1): _yt_named(
            _year_total_slice(t, "w", y1, col("ws_net_paid")), "w1",
            ["c_customer_id"]),
        ("w", 2): _yt_named(
            _year_total_slice(t, "w", y2, col("ws_net_paid")), "w2",
            ["c_customer_id"]),
    }
    j = _join(named[("s", 1)], named[("s", 2)],
              ["s1_c_customer_id"], ["s2_c_customer_id"])
    j = _join(j, named[("w", 1)], ["s1_c_customer_id"],
              ["w1_c_customer_id"])
    j = _join(j, named[("w", 2)], ["s1_c_customer_id"],
              ["w2_c_customer_id"])

    def growth(ch):
        return If(col(f"{ch}1_total") > lit(0.0),
                  col(f"{ch}2_total") / col(f"{ch}1_total"),
                  _Lit(None, _T.FLOAT64))
    f = CpuFilter(
        (col("s1_total") > lit(0.0)) & (col("w1_total") > lit(0.0)) &
        (growth("w") > growth("s")), j)
    out = CpuProject(
        [col("s2_c_customer_id").alias("customer_id"),
         col("s2_c_first_name").alias("customer_first_name"),
         col("s2_c_last_name").alias("customer_last_name")], f)
    return CpuLimit(100, CpuSort([asc(col("customer_id"))], out))


QUERIES.update({"q4": q4, "q11": q11, "q74": q74})


def _ctr_plan(t, returns, date_key, cust_key, addr_key, amt, year):
    """customer_total_return CTE (q30/q81): per-customer, per-state
    return totals for one year."""
    dd = CpuFilter(col("d_year") == lit(year), t["date_dim"])
    j = _join(_join(dd, returns, ["d_date_sk"], [date_key]),
              t["customer_address"], [addr_key], ["ca_address_sk"])
    return CpuAggregate(
        [col(cust_key), col("ca_state")],
        [Sum(col(amt)).alias("ctr_total_return")], j)


def _ctr_above_state_avg(t, ctr, cust_key):
    """ctr rows above 1.2x their state's average total return
    (correlated scalar subquery as aggregate re-join)."""
    avg = CpuProject(
        [col("ca_state").alias("avg_state"),
         (col("_a") * lit(1.2)).alias("threshold")],
        CpuAggregate([col("ca_state")],
                     [Average(col("ctr_total_return")).alias("_a")],
                     ctr))
    j = _join(ctr, avg, ["ca_state"], ["avg_state"])
    return CpuFilter(col("ctr_total_return") > col("threshold"), j)


def q30(t, run):
    """Reference q30: GA customers whose web-return total beats 1.2x
    their state average, with the full customer attribute list."""
    ctr = _ctr_plan(t, t["web_returns"], "wr_returned_date_sk",
                    "wr_returning_customer_sk", "wr_returning_addr_sk",
                    "wr_return_amt", 2002)
    top = _ctr_above_state_avg(t, ctr, "wr_returning_customer_sk")
    ga = CpuFilter(col("ca_state") == lit("GA"),
                   t["customer_address"])
    ga = CpuProject([col("ca_address_sk").alias("ga_addr")], ga)
    j = _join(top, t["customer"], ["wr_returning_customer_sk"],
              ["c_customer_sk"])
    j = _join(j, ga, ["c_current_addr_sk"], ["ga_addr"])
    cols = ["c_customer_id", "c_salutation", "c_first_name",
            "c_last_name", "c_preferred_cust_flag", "c_birth_day",
            "c_birth_month", "c_birth_year", "c_birth_country",
            "c_login", "c_email_address", "c_last_review_date"]
    out = CpuProject([col(c) for c in cols] +
                     [col("ctr_total_return")], j)
    return CpuLimit(100, CpuSort(
        [asc(col(c)) for c in cols] +
        [asc(col("ctr_total_return"))], out))


def q81(t, run):
    """Reference q81: q30's shape on catalog returns (amt_inc_tax),
    returning the full address attribute list."""
    ctr = _ctr_plan(t, t["catalog_returns"], "cr_returned_date_sk",
                    "cr_returning_customer_sk", "cr_returning_addr_sk",
                    "cr_return_amt_inc_tax", 2000)
    top = _ctr_above_state_avg(t, ctr, "cr_returning_customer_sk")
    j = _join(top, t["customer"], ["cr_returning_customer_sk"],
              ["c_customer_sk"])
    ga = CpuFilter(col("ca_state") == lit("GA"),
                   t["customer_address"])
    ga = CpuProject(
        [col("ca_address_sk").alias("ga_addr"),
         col("ca_street_number"), col("ca_street_name"),
         col("ca_street_type"), col("ca_suite_number"),
         col("ca_city").alias("cust_city"),
         col("ca_county").alias("cust_county"),
         col("ca_state").alias("cust_state"),
         col("ca_zip").alias("cust_zip"),
         col("ca_country").alias("cust_country"),
         col("ca_gmt_offset").alias("cust_gmt"),
         col("ca_location_type")], ga)
    j = _join(j, ga, ["c_current_addr_sk"], ["ga_addr"])
    cols = ["c_customer_id", "c_salutation", "c_first_name",
            "c_last_name", "ca_street_number", "ca_street_name",
            "ca_street_type", "ca_suite_number", "cust_city",
            "cust_county", "cust_state", "cust_zip", "cust_country",
            "cust_gmt", "ca_location_type"]
    out = CpuProject([col(c) for c in cols] +
                     [col("ctr_total_return")], j)
    return CpuLimit(100, CpuSort(
        [asc(col(c)) for c in cols] +
        [asc(col("ctr_total_return"))], out))


def q31(t, run):
    """Reference q31: counties where web sales grew faster than store
    sales across 2000 Q1->Q2->Q3."""
    def chan(sales, date_key, addr_key, val, alias):
        j = _join(_join(t["date_dim"], sales,
                        ["d_date_sk"], [date_key]),
                  t["customer_address"], [addr_key], ["ca_address_sk"])
        return CpuAggregate(
            [col("ca_county"), col("d_qoy"), col("d_year")],
            [Sum(col(val)).alias(alias)], j)

    ss = chan(t["store_sales"], "ss_sold_date_sk", "ss_addr_sk",
              "ss_ext_sales_price", "store_sales")
    ws = chan(t["web_sales"], "ws_sold_date_sk", "ws_bill_addr_sk",
              "ws_ext_sales_price", "web_sales")

    def slice_q(plan, qoy, tag, val):
        return CpuProject(
            [col("ca_county").alias(f"{tag}_county"),
             col(val).alias(f"{tag}_total")],
            CpuFilter((col("d_qoy") == lit(qoy)) &
                      (col("d_year") == lit(2000)), plan))

    j = _join(slice_q(ss, 1, "ss1", "store_sales"),
              slice_q(ss, 2, "ss2", "store_sales"),
              ["ss1_county"], ["ss2_county"])
    j = _join(j, slice_q(ss, 3, "ss3", "store_sales"),
              ["ss1_county"], ["ss3_county"])
    j = _join(j, slice_q(ws, 1, "ws1", "web_sales"),
              ["ss1_county"], ["ws1_county"])
    j = _join(j, slice_q(ws, 2, "ws2", "web_sales"),
              ["ss1_county"], ["ws2_county"])
    j = _join(j, slice_q(ws, 3, "ws3", "web_sales"),
              ["ss1_county"], ["ws3_county"])

    def ratio(hi, lo):
        return If(col(f"{lo}_total") > lit(0.0),
                  col(f"{hi}_total") / col(f"{lo}_total"),
                  _Lit(None, _T.FLOAT64))
    f = CpuFilter(
        (ratio("ws2", "ws1") > ratio("ss2", "ss1")) &
        (ratio("ws3", "ws2") > ratio("ss3", "ss2")), j)
    out = CpuProject(
        [col("ss1_county").alias("ca_county"),
         lit(2000).alias("d_year"),
         (col("ws2_total") / col("ws1_total")
          ).alias("web_q1_q2_increase"),
         (col("ss2_total") / col("ss1_total")
          ).alias("store_q1_q2_increase"),
         (col("ws3_total") / col("ws2_total")
          ).alias("web_q2_q3_increase"),
         (col("ss3_total") / col("ss2_total")
          ).alias("store_q2_q3_increase")], f)
    return CpuSort([asc(col("ca_county"))], out)


def q6(t, run):
    """Reference q6: states with >=10 customers who bought items priced
    over 1.2x their category average in one month."""
    month = CpuProject(
        [col("d_month_seq").alias("target_seq"), lit(1).alias("_mk")],
        CpuAggregate(
            [col("d_month_seq")], [Count(None).alias("_c")],
            CpuFilter((col("d_year") == lit(2001)) &
                      (col("d_moy") == lit(1)), t["date_dim"])))
    dd = CpuProject(
        [col("d_date_sk")],
        CpuFilter(col("d_month_seq") == col("target_seq"),
                  _join(CpuProject([col("d_date_sk"),
                                    col("d_month_seq"),
                                    lit(1).alias("_dk")],
                                   t["date_dim"]),
                        month, ["_dk"], ["_mk"])))
    cat_avg = CpuProject(
        [col("i_category").alias("avg_cat"),
         (col("_a") * lit(1.2)).alias("cat_threshold")],
        CpuAggregate([col("i_category")],
                     [Average(col("i_current_price")).alias("_a")],
                     t["item"]))
    it = CpuFilter(
        col("i_current_price") > col("cat_threshold"),
        _join(t["item"], cat_avg, ["i_category"], ["avg_cat"]))
    j = _join(_join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        t["customer"], ["ss_customer_sk"], ["c_customer_sk"]),
        t["customer_address"], ["c_current_addr_sk"],
        ["ca_address_sk"]),
        it, ["ss_item_sk"], ["i_item_sk"])
    agg = CpuAggregate([col("ca_state")],
                       [Count(None).alias("cnt")], j)
    # reference keeps states with >= 10 such customers; >= 5 stands
    # in at synthetic scale
    f = CpuFilter(col("cnt") >= lit(5), agg)
    out = CpuProject([col("ca_state").alias("state"), col("cnt")], f)
    return CpuLimit(100, CpuSort([asc(col("cnt"))], out))


def q32(t, run):
    """Reference q32: catalog discounts above 1.3x the per-item window
    average for one manufacturer."""
    dd = CpuFilter(_between(col("d_date"), _date(2000, 1, 27),
                            _date(2000, 4, 26)), t["date_dim"])
    cs = _join(dd, t["catalog_sales"],
               ["d_date_sk"], ["cs_sold_date_sk"])
    # reference manufacturer 977 stands in as 7 (a zipf-hot slice)
    it = CpuFilter(col("i_manufact_id") == lit(7), t["item"])
    j = _join(cs, it, ["cs_item_sk"], ["i_item_sk"])
    avg = CpuProject(
        [col("cs_item_sk").alias("_isk"),
         (col("_a") * lit(1.3)).alias("threshold")],
        CpuAggregate(
            [col("cs_item_sk")],
            [Average(col("cs_ext_discount_amt")).alias("_a")], cs))
    out = _join(j, avg, ["cs_item_sk"], ["_isk"])
    f = CpuFilter(col("cs_ext_discount_amt") > col("threshold"), out)
    return CpuLimit(100, CpuAggregate(
        [], [Sum(col("cs_ext_discount_amt")
                 ).alias("excess_discount_amount")], f))


def q83(t, run):
    """Reference q83: per-item return quantities across the three
    channels for three chosen weeks, with channel shares."""
    wk = CpuProject(
        [col("d_week_seq").alias("sel_wk")],
        CpuAggregate(
            [col("d_week_seq")], [Count(None).alias("_c")],
            CpuFilter(InSet(col("d_date"),
                            (_date(2000, 6, 30).value,
                             _date(2000, 9, 27).value,
                             _date(2000, 11, 17).value)),
                      t["date_dim"])))
    dates = CpuProject(
        [col("d_date_sk")],
        _join(t["date_dim"], wk, ["d_week_seq"], ["sel_wk"],
              jt=J.LEFT_SEMI))

    def items(returns, date_key, item_key, qty, alias):
        j = _join(_join(dates, returns, ["d_date_sk"], [date_key]),
                  t["item"], [item_key], ["i_item_sk"])
        return CpuAggregate([col("i_item_id")],
                            [Sum(col(qty)).alias(alias)], j)

    sr = items(t["store_returns"], "sr_returned_date_sk",
               "sr_item_sk", "sr_return_quantity", "sr_item_qty")
    cr = CpuProject(
        [col("i_item_id").alias("cr_id"), col("cr_item_qty")],
        items(t["catalog_returns"], "cr_returned_date_sk",
              "cr_item_sk", "cr_return_quantity", "cr_item_qty"))
    wr = CpuProject(
        [col("i_item_id").alias("wr_id"), col("wr_item_qty")],
        items(t["web_returns"], "wr_returned_date_sk",
              "wr_item_sk", "wr_return_quantity", "wr_item_qty"))
    j = _join(_join(sr, cr, ["i_item_id"], ["cr_id"]),
              wr, ["i_item_id"], ["wr_id"])
    total = (col("sr_item_qty") + col("cr_item_qty") +
             col("wr_item_qty"))

    def dev(q):
        return (col(q) / total / lit(3.0) * lit(100.0)
                ).alias(q.replace("item_qty", "dev"))
    out = CpuProject(
        [col("i_item_id").alias("item_id"), col("sr_item_qty"),
         dev("sr_item_qty"), col("cr_item_qty"), dev("cr_item_qty"),
         col("wr_item_qty"), dev("wr_item_qty"),
         (total / lit(3.0)).alias("average")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("item_id")), asc(col("sr_item_qty"))], out))


QUERIES.update({
    "q30": q30, "q81": q81, "q31": q31, "q6": q6, "q32": q32,
    "q83": q83,
})


def q36(t, run):
    """Reference q36: gross margin over ROLLUP(i_category, i_class)
    with grouping()-derived hierarchy level and rank within parent."""
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    # reference pins TN; the generator state domain stands in
    st = CpuFilter(InSet(col("s_state"), ("TX", "CA", "WA")),
                   t["store"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        t["item"], ["ss_item_sk"], ["i_item_sk"]),
        st, ["ss_store_sk"], ["s_store_sk"])
    pre = CpuProject(
        [col("i_category"), col("i_class"), col("ss_net_profit"),
         col("ss_ext_sales_price")], j)
    ex = _rollup_expand(pre, ["i_category", "i_class"],
                        ["ss_net_profit", "ss_ext_sales_price"])
    agg = CpuAggregate(
        [col("i_category"), col("i_class"), col("gid")],
        [Sum(col("ss_net_profit")).alias("_np"),
         Sum(col("ss_ext_sales_price")).alias("_esp")], ex)
    pre_w = CpuProject(
        [(col("_np") / col("_esp")).alias("gross_margin"),
         col("i_category"), col("i_class"),
         If(col("gid") == lit(3), lit(2),
            If(col("gid") == lit(1), lit(1), lit(0))
            ).alias("lochierarchy"),
         If(col("gid") == lit(0), col("i_category"),
            _Lit(None, _T.STRING)).alias("_parent_cat")], agg)
    w = CpuWindow(
        [Rank().alias("rank_within_parent")],
        WindowSpec([col("lochierarchy"), col("_parent_cat")],
                   [asc(col("gross_margin"))]), pre_w)
    keyed = CpuProject(
        [col("gross_margin"), col("i_category"), col("i_class"),
         col("lochierarchy"), col("rank_within_parent"),
         If(col("lochierarchy") == lit(0), col("i_category"),
            _Lit(None, _T.STRING)).alias("_ocat")], w)
    out = CpuLimit(100, CpuSort(
        [desc(col("lochierarchy")), asc(col("_ocat")),
         asc(col("rank_within_parent"))], keyed))
    return CpuProject(
        [col("gross_margin"), col("i_category"), col("i_class"),
         col("lochierarchy"), col("rank_within_parent")], out)


def q44(t, run):
    """Reference q44: best vs worst performing items by average net
    profit at one store, rank-aligned."""
    # reference store 4 stands in as the generator's store 2
    base = CpuFilter(col("ss_store_sk") == lit(2), t["store_sales"])
    per_item = CpuAggregate(
        [col("ss_item_sk")],
        [Average(col("ss_net_profit")).alias("rank_col")], base)
    null_addr = CpuProject(
        [(col("_a") * lit(0.9)).alias("threshold"),
         lit(1).alias("_tk")],
        CpuAggregate(
            [col("ss_store_sk")],
            [Average(col("ss_net_profit")).alias("_a")],
            CpuFilter(IsNull(col("ss_addr_sk")), base)))
    keyed = CpuProject(
        [col("ss_item_sk").alias("item_sk"), col("rank_col"),
         lit(1).alias("_pk")], per_item)
    v1 = CpuFilter(col("rank_col") > col("threshold"),
                   _join(keyed, null_addr, ["_pk"], ["_tk"]))

    def ranked(direction, tag):
        order = [asc(col("rank_col"))] if direction == "asc" else \
            [desc(col("rank_col"))]
        w = CpuWindow([Rank().alias("rnk")],
                      WindowSpec([], order), v1)
        return CpuProject(
            [col("item_sk").alias(f"{tag}_sk"),
             col("rnk").alias(f"{tag}_rnk")],
            CpuFilter(col("rnk") < lit(11), w))

    j = _join(ranked("asc", "up"), ranked("desc", "down"),
              ["up_rnk"], ["down_rnk"])
    i1 = CpuProject([col("i_item_sk").alias("i1_sk"),
                     col("i_product_name").alias("best_performing")],
                    t["item"])
    i2 = CpuProject([col("i_item_sk").alias("i2_sk"),
                     col("i_product_name").alias("worst_performing")],
                    t["item"])
    j = _join(_join(j, i1, ["up_sk"], ["i1_sk"]),
              i2, ["down_sk"], ["i2_sk"])
    out = CpuProject(
        [col("up_rnk").alias("rnk"), col("best_performing"),
         col("worst_performing")], j)
    return CpuLimit(100, CpuSort([asc(col("rnk"))], out))


def _v1_monthly(t, sales, date_key, item_key, entity_joins, groups,
                val):
    """q47/q57 v1 CTE: monthly sums + whole-partition average + rank
    over the month sequence."""
    dd = CpuFilter(
        (col("d_year") == lit(1999)) |
        ((col("d_year") == lit(1998)) & (col("d_moy") == lit(12))) |
        ((col("d_year") == lit(2000)) & (col("d_moy") == lit(1))),
        t["date_dim"])
    j = _join(_join(dd, sales, ["d_date_sk"], [date_key]),
              t["item"], [item_key], ["i_item_sk"])
    for right, lk, rk in entity_joins:
        j = _join(j, right, lk, rk)
    agg = CpuAggregate(
        [col(g) for g in groups + ["d_year", "d_moy"]],
        [Sum(col(val)).alias("sum_sales")], j)
    w = CpuWindow(
        [WinAvg(col("sum_sales")).alias("avg_monthly_sales")],
        WindowSpec([col(g) for g in groups] + [col("d_year")], [],
                   WindowFrame(is_rows=True, lower=None, upper=None)),
        agg)
    return CpuWindow(
        [Rank().alias("rn")],
        WindowSpec([col(g) for g in groups],
                   [asc(col("d_year")), asc(col("d_moy"))]), w)


def _lag_lead_tail(v1, groups, out_extra):
    """q47/q57 v2 + final filter: self-join v1 against rn+-1."""
    lag = CpuProject(
        [col(g).alias(f"lag_{g}") for g in groups] +
        [(col("rn") + lit(1)).alias("lag_rn"),
         col("sum_sales").alias("psum")], v1)
    lead = CpuProject(
        [col(g).alias(f"lead_{g}") for g in groups] +
        [(col("rn") - lit(1)).alias("lead_rn"),
         col("sum_sales").alias("nsum")], v1)
    j = _join(v1, lag, groups + ["rn"],
              [f"lag_{g}" for g in groups] + ["lag_rn"])
    j = _join(j, lead, groups + ["rn"],
              [f"lead_{g}" for g in groups] + ["lead_rn"])
    ratio = If(col("avg_monthly_sales") > lit(0.0),
               _Abs(col("sum_sales") - col("avg_monthly_sales")) /
               col("avg_monthly_sales"), _Lit(None, _T.FLOAT64))
    f = CpuFilter((col("d_year") == lit(1999)) &
                  (col("avg_monthly_sales") > lit(0.0)) &
                  (ratio > lit(0.1)), j)
    out = CpuProject(
        [col(g) for g in groups] +
        [col("d_year"), col("d_moy"), col("avg_monthly_sales"),
         col("sum_sales"), col("psum"), col("nsum"),
         (col("sum_sales") - col("avg_monthly_sales")).alias("_dev")] +
        out_extra, f)
    return CpuLimit(100, CpuSort(
        [asc(col("_dev")), asc(col(groups[0]))], out))


def q47(t, run):
    """Reference q47: store monthly sales deviations with neighboring
    months via rank self-joins."""
    groups = ["i_category", "i_brand", "s_store_name",
              "s_company_name"]
    v1 = _v1_monthly(
        t, t["store_sales"], "ss_sold_date_sk", "ss_item_sk",
        [(t["store"], ["ss_store_sk"], ["s_store_sk"])], groups,
        "ss_sales_price")
    return _lag_lead_tail(v1, groups, [])


def q57(t, run):
    """Reference q57: q47's shape on catalog sales by call center."""
    groups = ["i_category", "i_brand", "cc_name"]
    v1 = _v1_monthly(
        t, t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk",
        [(t["call_center"], ["cs_call_center_sk"],
          ["cc_call_center_sk"])], groups, "cs_sales_price")
    return _lag_lead_tail(v1, groups, [])


def q53(t, run):
    """Reference q53: manufacturer quarterly sales vs their windowed
    average, banded item slices."""
    # reference month_seq window 1200..1211 stands in as 12..23
    dd = CpuFilter(_between(col("d_month_seq"), lit(12), lit(23)),
                   t["date_dim"])
    # reference brand/class lists stand in as generator domains
    it = CpuFilter(
        (InSet(col("i_category"), ("Books", "Electronics", "Home")) &
         InSet(col("i_class"), ("class00", "class01", "class02",
                                "class03")) &
         InSet(col("i_brand"), ("brand#1", "brand#2"))) |
        (InSet(col("i_category"), ("Women", "Music", "Shoes")) &
         InSet(col("i_class"), ("class04", "class05", "class06",
                                "class07")) &
         InSet(col("i_brand"), ("brand#3", "brand#4"))), t["item"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        it, ["ss_item_sk"], ["i_item_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"])
    agg = CpuAggregate(
        [col("i_manufact_id"), col("d_qoy")],
        [Sum(col("ss_sales_price")).alias("sum_sales")], j)
    w = CpuWindow(
        [WinAvg(col("sum_sales")).alias("avg_quarterly_sales")],
        WindowSpec([col("i_manufact_id")], [],
                   WindowFrame(is_rows=True, lower=None, upper=None)),
        agg)
    ratio = If(col("avg_quarterly_sales") > lit(0.0),
               _Abs(col("sum_sales") - col("avg_quarterly_sales")) /
               col("avg_quarterly_sales"), _Lit(None, _T.FLOAT64))
    f = CpuFilter(ratio > lit(0.1), w)
    out = CpuProject([col("i_manufact_id"), col("sum_sales"),
                      col("avg_quarterly_sales")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("avg_quarterly_sales")), asc(col("sum_sales")),
         asc(col("i_manufact_id"))], out))


def q89(t, run):
    """Reference q89: monthly class sales vs the brand/store windowed
    average."""
    dd = CpuFilter(col("d_year") == lit(1999), t["date_dim"])
    it = CpuFilter(
        (InSet(col("i_category"), ("Books", "Electronics", "Sports")) &
         InSet(col("i_class"), ("class00", "class01", "class02"))) |
        (InSet(col("i_category"), ("Men", "Jewelry", "Women")) &
         InSet(col("i_class"), ("class03", "class04", "class05"))),
        t["item"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        it, ["ss_item_sk"], ["i_item_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"])
    agg = CpuAggregate(
        [col("i_category"), col("i_class"), col("i_brand"),
         col("s_store_name"), col("s_company_name"), col("d_moy")],
        [Sum(col("ss_sales_price")).alias("sum_sales")], j)
    w = CpuWindow(
        [WinAvg(col("sum_sales")).alias("avg_monthly_sales")],
        WindowSpec([col("i_category"), col("i_brand"),
                    col("s_store_name"), col("s_company_name")], [],
                   WindowFrame(is_rows=True, lower=None, upper=None)),
        agg)
    ratio = If(col("avg_monthly_sales") != lit(0.0),
               _Abs(col("sum_sales") - col("avg_monthly_sales")) /
               col("avg_monthly_sales"), _Lit(None, _T.FLOAT64))
    f = CpuFilter(ratio > lit(0.1), w)
    out = CpuProject(
        [col("i_category"), col("i_class"), col("i_brand"),
         col("s_store_name"), col("s_company_name"), col("d_moy"),
         col("sum_sales"), col("avg_monthly_sales"),
         (col("sum_sales") - col("avg_monthly_sales")).alias("_dev")],
        f)
    return CpuLimit(100, CpuSort(
        [asc(col("_dev")), asc(col("s_store_name"))], out))


QUERIES.update({
    "q36": q36, "q44": q44, "q47": q47, "q57": q57, "q53": q53,
    "q89": q89,
})


def _q49_channel(t, sales, returns, order_keys, ret_keys, qty, rqty,
                 amt, ramt, paid, profit, date_key, item_key, chan):
    j = _join(t[sales], t[returns], order_keys, ret_keys,
              jt=J.LEFT_OUTER)
    # reference thresholds (return_amt > 10000, d_moy = 12) stand in
    # as amounts/periods the synthetic scale can populate
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    j = _join(j, dd, [date_key], ["d_date_sk"])
    f = CpuFilter((col(ramt) > lit(500.0)) &
                  (col(profit) > lit(1.0)) &
                  (col(paid) > lit(0.0)) &
                  (col(qty) > lit(0)), j)
    agg = CpuAggregate(
        [col(item_key)],
        [Sum(Coalesce((col(rqty), lit(0)))).alias("_rq"),
         Sum(Coalesce((col(qty), lit(0)))).alias("_q"),
         Sum(Coalesce((col(ramt), lit(0.0)))).alias("_ra"),
         Sum(Coalesce((col(paid), lit(0.0)))).alias("_p")], f)
    ratios = CpuProject(
        [col(item_key).alias("item"),
         (col("_rq") / col("_q")).alias("return_ratio"),
         (col("_ra") / col("_p")).alias("currency_ratio")], agg)
    w = CpuWindow(
        [Rank().alias("return_rank")],
        WindowSpec([], [asc(col("return_ratio"))]), ratios)
    w = CpuWindow(
        [Rank().alias("currency_rank")],
        WindowSpec([], [asc(col("currency_ratio"))]), w)
    f2 = CpuFilter((col("return_rank") <= lit(10)) |
                   (col("currency_rank") <= lit(10)), w)
    return CpuProject(
        [lit(chan).alias("channel"), col("item"), col("return_ratio"),
         col("return_rank"), col("currency_rank")], f2)


def q49(t, run):
    """Reference q49: worst return ratios by channel, rank-unioned
    (UNION distinct via grouped dedup)."""
    u = CpuUnion(
        _q49_channel(t, "web_sales", "web_returns",
                     ["ws_order_number", "ws_item_sk"],
                     ["wr_order_number", "wr_item_sk"],
                     "ws_quantity", "wr_return_quantity",
                     "ws_ext_sales_price", "wr_return_amt",
                     "ws_net_paid", "ws_net_profit",
                     "ws_sold_date_sk", "ws_item_sk", "web"),
        _q49_channel(t, "catalog_sales", "catalog_returns",
                     ["cs_order_number", "cs_item_sk"],
                     ["cr_order_number", "cr_item_sk"],
                     "cs_quantity", "cr_return_quantity",
                     "cs_ext_sales_price", "cr_return_amount",
                     "cs_net_paid", "cs_net_profit",
                     "cs_sold_date_sk", "cs_item_sk", "catalog"),
        _q49_channel(t, "store_sales", "store_returns",
                     ["ss_ticket_number", "ss_item_sk"],
                     ["sr_ticket_number", "sr_item_sk"],
                     "ss_quantity", "sr_return_quantity",
                     "ss_ext_sales_price", "sr_return_amt",
                     "ss_net_paid", "ss_net_profit",
                     "ss_sold_date_sk", "ss_item_sk", "store"))
    dedup = CpuProject(
        [col("channel"), col("item"), col("return_ratio"),
         col("return_rank"), col("currency_rank")],
        CpuAggregate(
            [col("channel"), col("item"), col("return_ratio"),
             col("return_rank"), col("currency_rank")],
            [Count(None).alias("_n")], u))
    return CpuLimit(100, CpuSort(
        [asc(col("channel")), asc(col("return_rank")),
         asc(col("currency_rank"))], dedup))


def q51(t, run):
    """Reference q51: cumulative web vs store sales per item (windowed
    running sums, full outer join, running max comparison)."""
    cume_frame = WindowFrame(is_rows=True, lower=None, upper=0)

    def v1(sales, date_key, item_key, price, tag):
        # reference month_seq window 1200..1211 stands in as 12..23
        dd = CpuFilter(_between(col("d_month_seq"), lit(12), lit(23)),
                       t["date_dim"])
        j = _join(dd, t[sales], ["d_date_sk"], [date_key])
        agg = CpuAggregate(
            [col(item_key), col("d_date")],
            [Sum(col(price)).alias("_s")], j)
        w = CpuWindow(
            [WinSum(col("_s")).alias("cume_sales")],
            WindowSpec([col(item_key)], [asc(col("d_date"))],
                       cume_frame), agg)
        return CpuProject(
            [col(item_key).alias(f"{tag}_item"),
             col("d_date").alias(f"{tag}_date"),
             col("cume_sales").alias(f"{tag}_cume")], w)

    web = v1("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_sales_price", "web")
    store = v1("store_sales", "ss_sold_date_sk", "ss_item_sk",
               "ss_sales_price", "store")
    fo = _join(web, store, ["web_item", "web_date"],
               ["store_item", "store_date"], jt=J.FULL_OUTER)
    x = CpuProject(
        [If(IsNotNull(col("web_item")), col("web_item"),
            col("store_item")).alias("item_sk"),
         If(IsNotNull(col("web_date")), col("web_date"),
            col("store_date")).alias("d_date"),
         col("web_cume").alias("web_sales"),
         col("store_cume").alias("store_sales")], fo)
    y = CpuWindow(
        [WinMax(col("web_sales")).alias("web_cumulative"),
         WinMax(col("store_sales")).alias("store_cumulative")],
        WindowSpec([col("item_sk")], [asc(col("d_date"))], cume_frame),
        x)
    f = CpuFilter(col("web_cumulative") > col("store_cumulative"), y)
    out = CpuProject(
        [col("item_sk"), col("d_date"), col("web_sales"),
         col("store_sales"), col("web_cumulative"),
         col("store_cumulative")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("item_sk")), asc(col("d_date"))], out))


def q67(t, run):
    """Reference q67: top items by sales over an 8-level ROLLUP, ranked
    within category."""
    dd = CpuFilter(_between(col("d_month_seq"), lit(12), lit(23)),
                   t["date_dim"])
    j = _join(_join(_join(
        dd, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"]),
        t["store"], ["ss_store_sk"], ["s_store_sk"]),
        t["item"], ["ss_item_sk"], ["i_item_sk"])
    pre = CpuProject(
        [col("i_category"), col("i_class"), col("i_brand"),
         col("i_product_name"), col("d_year"), col("d_qoy"),
         col("d_moy"), col("s_store_id"),
         Coalesce((col("ss_sales_price") * col("ss_quantity"),
                   lit(0.0))).alias("_amt")], j)
    keys = ["i_category", "i_class", "i_brand", "i_product_name",
            "d_year", "d_qoy", "d_moy", "s_store_id"]
    ex = _rollup_expand(pre, keys, ["_amt"])
    agg = CpuAggregate(
        [col(k) for k in keys] + [col("gid")],
        [Sum(col("_amt")).alias("sumsales")], ex)
    w = CpuWindow(
        [Rank().alias("rk")],
        WindowSpec([col("i_category")], [desc(col("sumsales"))]), agg)
    f = CpuFilter(col("rk") <= lit(100), w)
    out = CpuProject([col(k) for k in keys] +
                     [col("sumsales"), col("rk")], f)
    return CpuLimit(100, CpuSort(
        [asc(col(k)) for k in keys] +
        [asc(col("sumsales")), asc(col("rk"))], out))


def q70(t, run):
    """Reference q70: profit over ROLLUP(s_state, s_county) limited to
    top-ranked states, with hierarchy ranks."""
    dd = CpuFilter(_between(col("d_month_seq"), lit(12), lit(23)),
                   t["date_dim"])
    base = _join(_join(dd, t["store_sales"],
                       ["d_date_sk"], ["ss_sold_date_sk"]),
                 t["store"], ["ss_store_sk"], ["s_store_sk"])
    by_state = CpuAggregate(
        [col("s_state")], [Sum(col("ss_net_profit")).alias("_p")],
        base)
    ranked = CpuWindow(
        [Rank().alias("ranking")],
        WindowSpec([col("s_state")], [desc(col("_p"))]), by_state)
    top_states = CpuProject(
        [col("s_state").alias("sel_state")],
        CpuFilter(col("ranking") <= lit(5), ranked))
    j = _join(base, top_states, ["s_state"], ["sel_state"],
              jt=J.LEFT_SEMI)
    pre = CpuProject(
        [col("s_state"), col("s_county"), col("ss_net_profit")], j)
    ex = _rollup_expand(pre, ["s_state", "s_county"],
                        ["ss_net_profit"])
    agg = CpuAggregate(
        [col("s_state"), col("s_county"), col("gid")],
        [Sum(col("ss_net_profit")).alias("total_sum")], ex)
    pre_w = CpuProject(
        [col("total_sum"), col("s_state"), col("s_county"),
         If(col("gid") == lit(3), lit(2),
            If(col("gid") == lit(1), lit(1), lit(0))
            ).alias("lochierarchy"),
         If(col("gid") == lit(0), col("s_state"),
            _Lit(None, _T.STRING)).alias("_parent_state")], agg)
    w = CpuWindow(
        [Rank().alias("rank_within_parent")],
        WindowSpec([col("lochierarchy"), col("_parent_state")],
                   [desc(col("total_sum"))]), pre_w)
    keyed = CpuProject(
        [col("total_sum"), col("s_state"), col("s_county"),
         col("lochierarchy"), col("rank_within_parent"),
         If(col("lochierarchy") == lit(0), col("s_state"),
            _Lit(None, _T.STRING)).alias("_ostate")], w)
    out = CpuLimit(100, CpuSort(
        [desc(col("lochierarchy")), asc(col("_ostate")),
         asc(col("rank_within_parent"))], keyed))
    return CpuProject(
        [col("total_sum"), col("s_state"), col("s_county"),
         col("lochierarchy"), col("rank_within_parent")], out)


QUERIES.update({"q49": q49, "q51": q51, "q67": q67, "q70": q70})


def _active_customers(t, year):
    """q10/q35 EXISTS machinery: distinct active-customer key sets per
    channel; exists A and (exists B or exists C) = semi join on A, then
    semi join on (B union C)."""
    def chan(sales, date_key, cust_key, extra):
        dd = CpuFilter((col("d_year") == lit(year)) & extra,
                       t["date_dim"])
        j = _join(dd, sales, ["d_date_sk"], [date_key])
        return CpuProject(
            [col("_k")],
            CpuAggregate([col(cust_key).alias("_k")],
                         [Count(None).alias("_n")],
                         CpuProject([col(cust_key)], j)))
    return chan


def _q10_35(t, year, extra, group_cols, aggs, order_cols):
    chan = _active_customers(t, year)
    ss = chan(t["store_sales"], "ss_sold_date_sk", "ss_customer_sk",
              extra)
    ws = chan(t["web_sales"], "ws_sold_date_sk",
              "ws_bill_customer_sk", extra)
    cs = chan(t["catalog_sales"], "cs_sold_date_sk",
              "cs_ship_customer_sk", extra)
    wc = CpuProject(
        [col("_k")],
        CpuAggregate([col("_k")], [Count(None).alias("_n")],
                     CpuUnion(ws, cs)))
    j = _join(t["customer"], t["customer_address"],
              ["c_current_addr_sk"], ["ca_address_sk"])
    j = _join(j, t["customer_demographics"],
              ["c_current_cdemo_sk"], ["cd_demo_sk"])
    j = _join(j, ss, ["c_customer_sk"], ["_k"], jt=J.LEFT_SEMI)
    j = _join(j, wc, ["c_customer_sk"], ["_k"], jt=J.LEFT_SEMI)
    return j


def q10(t, run):
    """Reference q10: demographic profile of county customers active
    in store AND (web OR catalog) channels in one quarter."""
    extra = _between(col("d_moy"), lit(1), lit(4))
    j = _q10_35(t, 2002, extra, None, None, None)
    # reference county list stands in as the generator county domain
    j = CpuFilter(InSet(col("ca_county"),
                        ("Williamson County", "Ziebach County",
                         "Walker County")), j)
    groups = ["cd_gender", "cd_marital_status", "cd_education_status",
              "cd_purchase_estimate", "cd_credit_rating",
              "cd_dep_count", "cd_dep_employed_count",
              "cd_dep_college_count"]
    agg = CpuAggregate([col(g) for g in groups],
                       [Count(None).alias("cnt")], j)
    out = CpuProject(
        [col("cd_gender"), col("cd_marital_status"),
         col("cd_education_status"), col("cnt").alias("cnt1"),
         col("cd_purchase_estimate"), col("cnt").alias("cnt2"),
         col("cd_credit_rating"), col("cnt").alias("cnt3"),
         col("cd_dep_count"), col("cnt").alias("cnt4"),
         col("cd_dep_employed_count"), col("cnt").alias("cnt5"),
         col("cd_dep_college_count"), col("cnt").alias("cnt6")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col(g)) for g in ("cd_gender", "cd_marital_status",
                               "cd_education_status",
                               "cd_purchase_estimate",
                               "cd_credit_rating", "cd_dep_count",
                               "cd_dep_employed_count",
                               "cd_dep_college_count")], out))


def q35(t, run):
    """Reference q35: per-state dependent-count stats for multi-channel
    active customers."""
    extra = col("d_qoy") < lit(4)
    j = _q10_35(t, 2002, extra, None, None, None)
    groups = ["ca_state", "cd_gender", "cd_marital_status",
              "cd_dep_count", "cd_dep_employed_count",
              "cd_dep_college_count"]
    agg = CpuAggregate(
        [col(g) for g in groups],
        [Count(None).alias("cnt1"),
         Min(col("cd_dep_count")).alias("min_dep"),
         Max(col("cd_dep_count")).alias("max_dep"),
         Average(col("cd_dep_count")).alias("avg_dep"),
         Min(col("cd_dep_employed_count")).alias("min_emp"),
         Max(col("cd_dep_employed_count")).alias("max_emp"),
         Average(col("cd_dep_employed_count")).alias("avg_emp"),
         Min(col("cd_dep_college_count")).alias("min_col"),
         Max(col("cd_dep_college_count")).alias("max_col"),
         Average(col("cd_dep_college_count")).alias("avg_col")], j)
    return CpuLimit(100, CpuSort(
        [asc(col(g)) for g in groups], agg))


def q85(t, run):
    """Reference q85: web-return reasons under matched refunding/
    returning demographics and address/profit bands."""
    j = _join(t["web_sales"], t["web_returns"],
              ["ws_item_sk", "ws_order_number"],
              ["wr_item_sk", "wr_order_number"])
    j = _join(j, t["web_page"], ["ws_web_page_sk"],
              ["wp_web_page_sk"])
    dd = CpuFilter(col("d_year") == lit(2000), t["date_dim"])
    j = _join(j, dd, ["ws_sold_date_sk"], ["d_date_sk"])
    cd1 = CpuProject(
        [col("cd_demo_sk").alias("cd1_sk"),
         col("cd_marital_status").alias("cd1_ms"),
         col("cd_education_status").alias("cd1_es")],
        t["customer_demographics"])
    cd2 = CpuProject(
        [col("cd_demo_sk").alias("cd2_sk"),
         col("cd_marital_status").alias("cd2_ms"),
         col("cd_education_status").alias("cd2_es")],
        t["customer_demographics"])
    j = _join(j, cd1, ["wr_refunded_cdemo_sk"], ["cd1_sk"])
    j = _join(j, cd2, ["wr_returning_cdemo_sk"], ["cd2_sk"])
    j = _join(j, t["customer_address"], ["wr_refunded_addr_sk"],
              ["ca_address_sk"])
    j = _join(j, t["reason"], ["wr_reason_sk"], ["r_reason_sk"])

    def band(ms, es, lo, hi):
        return ((col("cd1_ms") == lit(ms)) &
                (col("cd1_ms") == col("cd2_ms")) &
                (col("cd1_es") == lit(es)) &
                (col("cd1_es") == col("cd2_es")) &
                _between(col("ws_sales_price"), lit(lo), lit(hi)))
    # reference price bands (100-150 etc.) stand in as wider bands
    # the synthetic price range populates
    demo = (band("M", "Advanced Degree", 50.0, 250.0) |
            band("S", "College", 25.0, 250.0) |
            band("W", "2 yr Degree", 50.0, 250.0))
    # reference profit bands (100..200 etc.) stand in as the wider
    # q48-style bands the synthetic profit range supports
    addr = (
        (col("ca_country") == lit("United States")) &
        (InSet(col("ca_state"), ("TX", "NY")) &
         _between(col("ws_net_profit"), lit(-500), lit(2000)) |
         InSet(col("ca_state"), ("CA", "IL")) &
         _between(col("ws_net_profit"), lit(-250), lit(3000)) |
         InSet(col("ca_state"), ("WA", "GA")) &
         _between(col("ws_net_profit"), lit(0), lit(25000))))
    f = CpuFilter(demo & addr, j)
    agg = CpuAggregate(
        [col("r_reason_desc")],
        [Average(col("ws_quantity")).alias("avg_qty"),
         Average(col("wr_refunded_cash")).alias("avg_cash"),
         Average(col("wr_fee")).alias("avg_fee")], f)
    out = CpuProject(
        [_Substring(col("r_reason_desc"), lit(1),
                    lit(20)).alias("reason"),
         col("avg_qty"), col("avg_cash"), col("avg_fee")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("reason")), asc(col("avg_qty")), asc(col("avg_cash")),
         asc(col("avg_fee"))], out))


def q18(t, run):
    """Reference q18: catalog averages over ROLLUP(i_item_id,
    ca_country, ca_state, ca_county) for one demographic slice."""
    cd1 = CpuProject(
        [col("cd_demo_sk").alias("cd1_sk"),
         col("cd_dep_count").alias("cd1_dep")],
        CpuFilter((col("cd_gender") == lit("F")) &
                  (col("cd_education_status") == lit("Unknown")),
                  t["customer_demographics"]))
    cd2 = CpuProject([col("cd_demo_sk").alias("cd2_sk")],
                     t["customer_demographics"])
    dd = CpuFilter(col("d_year") == lit(1998), t["date_dim"])
    cust = CpuFilter(InSet(col("c_birth_month"), (1, 6, 8, 9, 12, 2)),
                     t["customer"])
    j = _join(dd, t["catalog_sales"], ["d_date_sk"],
              ["cs_sold_date_sk"])
    j = _join(j, cd1, ["cs_bill_cdemo_sk"], ["cd1_sk"])
    j = _join(j, cust, ["cs_bill_customer_sk"], ["c_customer_sk"])
    j = _join(j, cd2, ["c_current_cdemo_sk"], ["cd2_sk"])
    # reference state list stands in as the generator state domain
    ca = CpuFilter(InSet(col("ca_state"), ("TX", "NY", "CA")),
                   t["customer_address"])
    j = _join(j, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    j = _join(j, t["item"], ["cs_item_sk"], ["i_item_sk"])
    pre = CpuProject(
        [col("i_item_id"), col("ca_country"), col("ca_state"),
         col("ca_county"), col("cs_quantity"), col("cs_list_price"),
         col("cs_coupon_amt"), col("cs_sales_price"),
         col("cs_net_profit"), col("c_birth_year"), col("cd1_dep")], j)
    keys = ["i_item_id", "ca_country", "ca_state", "ca_county"]
    ex = _rollup_expand(pre, keys,
                        ["cs_quantity", "cs_list_price",
                         "cs_coupon_amt", "cs_sales_price",
                         "cs_net_profit", "c_birth_year", "cd1_dep"])
    agg = CpuAggregate(
        [col(k) for k in keys] + [col("gid")],
        [Average(col("cs_quantity")).alias("agg1"),
         Average(col("cs_list_price")).alias("agg2"),
         Average(col("cs_coupon_amt")).alias("agg3"),
         Average(col("cs_sales_price")).alias("agg4"),
         Average(col("cs_net_profit")).alias("agg5"),
         Average(col("c_birth_year")).alias("agg6"),
         Average(col("cd1_dep")).alias("agg7")], ex)
    out = CpuProject([col(k) for k in keys] +
                     [col(f"agg{i}") for i in range(1, 8)], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("ca_country")), asc(col("ca_state")),
         asc(col("ca_county")), asc(col("i_item_id"))], out))


QUERIES.update({"q10": q10, "q35": q35, "q85": q85, "q18": q18})


def _rollup_channel_tail(u):
    """q5/q77/q80 shared tail: re-aggregate the unioned channel rows
    over ROLLUP(channel, id)."""
    ex = _rollup_expand(u, ["channel", "id"],
                        ["sales", "returns", "profit"])
    agg = CpuAggregate(
        [col("channel"), col("id"), col("gid")],
        [Sum(col("sales")).alias("sales"),
         Sum(col("returns")).alias("returns"),
         Sum(col("profit")).alias("profit")], ex)
    out = CpuProject(
        [col("channel"), col("id"), col("sales"), col("returns"),
         col("profit")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("channel")), asc(col("id"))], out))


def q5(t, run):
    """Reference q5: 14-day sales/returns/profit per channel entity
    over ROLLUP(channel, id)."""
    d_lo, d_hi = _date(2000, 8, 23), _date(2000, 9, 6)
    dd = CpuFilter(_between(col("d_date"), d_lo, d_hi), t["date_dim"])

    def union_sr(sales_proj, returns_proj):
        return CpuUnion(sales_proj, returns_proj)

    # store channel
    ss = CpuProject(
        [col("ss_store_sk").alias("entity_sk"),
         col("ss_sold_date_sk").alias("date_sk"),
         col("ss_ext_sales_price").alias("sales_price"),
         col("ss_net_profit").alias("profit"),
         lit(0.0).alias("return_amt"), lit(0.0).alias("net_loss")],
        t["store_sales"])
    sr = CpuProject(
        [col("sr_store_sk").alias("entity_sk"),
         col("sr_returned_date_sk").alias("date_sk"),
         lit(0.0).alias("sales_price"), lit(0.0).alias("profit"),
         col("sr_return_amt").alias("return_amt"),
         col("sr_net_loss").alias("net_loss")], t["store_returns"])
    ssr = _join(_join(union_sr(ss, sr), dd, ["date_sk"],
                      ["d_date_sk"]),
                t["store"], ["entity_sk"], ["s_store_sk"])
    ssr = CpuAggregate(
        [col("s_store_id")],
        [Sum(col("sales_price")).alias("sales"),
         Sum(col("profit")).alias("profit"),
         Sum(col("return_amt")).alias("returns"),
         Sum(col("net_loss")).alias("profit_loss")], ssr)
    store_rows = CpuProject(
        [lit("store channel").alias("channel"),
         ConcatStrings((lit("store"), col("s_store_id"))).alias("id"),
         col("sales"), col("returns"),
         (col("profit") - col("profit_loss")).alias("profit")], ssr)

    # catalog channel
    cs = CpuProject(
        [col("cs_catalog_page_sk").alias("page_sk"),
         col("cs_sold_date_sk").alias("date_sk"),
         col("cs_ext_sales_price").alias("sales_price"),
         col("cs_net_profit").alias("profit"),
         lit(0.0).alias("return_amt"), lit(0.0).alias("net_loss")],
        t["catalog_sales"])
    cr = CpuProject(
        [col("cr_catalog_page_sk").alias("page_sk"),
         col("cr_returned_date_sk").alias("date_sk"),
         lit(0.0).alias("sales_price"), lit(0.0).alias("profit"),
         col("cr_return_amount").alias("return_amt"),
         col("cr_net_loss").alias("net_loss")], t["catalog_returns"])
    csr = _join(_join(union_sr(cs, cr), dd, ["date_sk"],
                      ["d_date_sk"]),
                t["catalog_page"], ["page_sk"],
                ["cp_catalog_page_sk"])
    csr = CpuAggregate(
        [col("cp_catalog_page_id")],
        [Sum(col("sales_price")).alias("sales"),
         Sum(col("profit")).alias("profit"),
         Sum(col("return_amt")).alias("returns"),
         Sum(col("net_loss")).alias("profit_loss")], csr)
    catalog_rows = CpuProject(
        [lit("catalog channel").alias("channel"),
         ConcatStrings((lit("catalog_page"),
                        col("cp_catalog_page_id"))).alias("id"),
         col("sales"), col("returns"),
         (col("profit") - col("profit_loss")).alias("profit")], csr)

    # web channel (returns joined back to sales for the site key)
    ws = CpuProject(
        [col("ws_web_site_sk").alias("site_sk"),
         col("ws_sold_date_sk").alias("date_sk"),
         col("ws_ext_sales_price").alias("sales_price"),
         col("ws_net_profit").alias("profit"),
         lit(0.0).alias("return_amt"), lit(0.0).alias("net_loss")],
        t["web_sales"])
    wr_join = _join(t["web_returns"],
                    CpuProject([col("ws_item_sk").alias("wi"),
                                col("ws_order_number").alias("wo"),
                                col("ws_web_site_sk")],
                               t["web_sales"]),
                    ["wr_item_sk", "wr_order_number"], ["wi", "wo"],
                    jt=J.LEFT_OUTER)
    wr = CpuProject(
        [col("ws_web_site_sk").alias("site_sk"),
         col("wr_returned_date_sk").alias("date_sk"),
         lit(0.0).alias("sales_price"), lit(0.0).alias("profit"),
         col("wr_return_amt").alias("return_amt"),
         col("wr_net_loss").alias("net_loss")], wr_join)
    wsr = _join(_join(union_sr(ws, wr), dd, ["date_sk"],
                      ["d_date_sk"]),
                t["web_site"], ["site_sk"], ["web_site_sk"])
    wsr = CpuAggregate(
        [col("web_site_id")],
        [Sum(col("sales_price")).alias("sales"),
         Sum(col("profit")).alias("profit"),
         Sum(col("return_amt")).alias("returns"),
         Sum(col("net_loss")).alias("profit_loss")], wsr)
    web_rows = CpuProject(
        [lit("web channel").alias("channel"),
         ConcatStrings((lit("web_site"),
                        col("web_site_id"))).alias("id"),
         col("sales"), col("returns"),
         (col("profit") - col("profit_loss")).alias("profit")], wsr)

    return _rollup_channel_tail(
        CpuUnion(store_rows, catalog_rows, web_rows))


def q77(t, run):
    """Reference q77: 30-day per-entity sales vs returns per channel,
    rollup-totaled (catalog side cross-joined)."""
    d_lo, d_hi = _date(2000, 8, 23), _date(2000, 9, 22)
    dd = CpuFilter(_between(col("d_date"), d_lo, d_hi), t["date_dim"])

    def agg_side(child, date_key, ent, sums):
        j = _join(dd, child, ["d_date_sk"], [date_key])
        return CpuAggregate(
            [col(ent)],
            [Sum(col(c)).alias(a) for c, a in sums], j)

    ss = agg_side(t["store_sales"], "ss_sold_date_sk", "ss_store_sk",
                  [("ss_ext_sales_price", "sales"),
                   ("ss_net_profit", "profit")])
    sr = CpuProject(
        [col("sr_store_sk").alias("r_sk"), col("returns"),
         col("profit_loss")],
        agg_side(t["store_returns"], "sr_returned_date_sk",
                 "sr_store_sk",
                 [("sr_return_amt", "returns"),
                  ("sr_net_loss", "profit_loss")]))
    store_rows = CpuProject(
        [lit("store channel").alias("channel"),
         col("ss_store_sk").alias("id"), col("sales"),
         Coalesce((col("returns"), lit(0.0))).alias("returns"),
         (col("profit") - Coalesce((col("profit_loss"), lit(0.0)))
          ).alias("profit")],
        _join(ss, sr, ["ss_store_sk"], ["r_sk"], jt=J.LEFT_OUTER))

    cs = CpuProject(
        [col("cs_call_center_sk"), col("sales"), col("profit"),
         lit(1).alias("_ck")],
        agg_side(t["catalog_sales"], "cs_sold_date_sk",
                 "cs_call_center_sk",
                 [("cs_ext_sales_price", "sales"),
                  ("cs_net_profit", "profit")]))
    cr = CpuProject(
        [col("returns"), col("profit_loss"), lit(1).alias("_rk")],
        CpuAggregate(
            [], [Sum(col("cr_return_amount")).alias("returns"),
                 Sum(col("cr_net_loss")).alias("profit_loss")],
            _join(dd, t["catalog_returns"], ["d_date_sk"],
                  ["cr_returned_date_sk"])))
    catalog_rows = CpuProject(
        [lit("catalog channel").alias("channel"),
         col("cs_call_center_sk").alias("id"), col("sales"),
         col("returns"),
         (col("profit") - col("profit_loss")).alias("profit")],
        _join(cs, cr, ["_ck"], ["_rk"]))

    ws = agg_side(
        _join(t["web_sales"], t["web_page"], ["ws_web_page_sk"],
              ["wp_web_page_sk"]),
        "ws_sold_date_sk", "wp_web_page_sk",
        [("ws_ext_sales_price", "sales"), ("ws_net_profit", "profit")])
    wr = CpuProject(
        [col("wp_web_page_sk").alias("r_sk"), col("returns"),
         col("profit_loss")],
        agg_side(
            _join(t["web_returns"], t["web_page"], ["wr_web_page_sk"],
                  ["wp_web_page_sk"]),
            "wr_returned_date_sk", "wp_web_page_sk",
            [("wr_return_amt", "returns"),
             ("wr_net_loss", "profit_loss")]))
    web_rows = CpuProject(
        [lit("web channel").alias("channel"),
         col("wp_web_page_sk").alias("id"), col("sales"),
         Coalesce((col("returns"), lit(0.0))).alias("returns"),
         (col("profit") - Coalesce((col("profit_loss"), lit(0.0)))
          ).alias("profit")],
        _join(ws, wr, ["wp_web_page_sk"], ["r_sk"], jt=J.LEFT_OUTER))

    # ids are entity sks (ints): normalize to strings for the shared
    # rollup tail like the reference's concat'd ids
    def str_id(rows):
        return CpuProject(
            [col("channel"),
             Cast(col("id"), _T.INT64).alias("id_int"), col("sales"),
             col("returns"), col("profit")], rows)
    u = CpuUnion(str_id(store_rows), str_id(catalog_rows),
                 str_id(web_rows))
    ex = _rollup_expand(u, ["channel", "id_int"],
                        ["sales", "returns", "profit"])
    agg = CpuAggregate(
        [col("channel"), col("id_int"), col("gid")],
        [Sum(col("sales")).alias("sales"),
         Sum(col("returns")).alias("returns"),
         Sum(col("profit")).alias("profit")], ex)
    out = CpuProject(
        [col("channel"), col("id_int").alias("id"), col("sales"),
         col("returns"), col("profit")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("channel")), asc(col("id"))], out))


def q80(t, run):
    """Reference q80: 30-day promo'd high-price item sales net of
    returns per channel entity, rollup-totaled."""
    d_lo, d_hi = _date(2000, 8, 23), _date(2000, 9, 22)
    dd = CpuFilter(_between(col("d_date"), d_lo, d_hi), t["date_dim"])
    it = CpuFilter(col("i_current_price") > lit(50.0), t["item"])
    pr = CpuFilter(col("p_channel_tv") == lit("N"), t["promotion"])

    def channel(sales, returns, skeys, rkeys, date_key, item_key,
                promo_key, ent_join, ent_id, price, profit, ramt,
                rloss, chan, prefix):
        j = _join(t[sales], t[returns], skeys, rkeys, jt=J.LEFT_OUTER)
        j = _join(j, dd, [date_key], ["d_date_sk"])
        j = _join(j, it, [item_key], ["i_item_sk"])
        j = _join(j, pr, [promo_key], ["p_promo_sk"])
        right, lk, rk = ent_join
        j = _join(j, right, lk, rk)
        agg = CpuAggregate(
            [col(ent_id)],
            [Sum(col(price)).alias("sales"),
             Sum(Coalesce((col(ramt), lit(0.0)))).alias("returns"),
             Sum(col(profit) - Coalesce((col(rloss), lit(0.0)))
                 ).alias("profit")], j)
        return CpuProject(
            [lit(chan).alias("channel"),
             ConcatStrings((lit(prefix), col(ent_id))).alias("id"),
             col("sales"), col("returns"), col("profit")], agg)

    store_rows = channel(
        "store_sales", "store_returns",
        ["ss_item_sk", "ss_ticket_number"],
        ["sr_item_sk", "sr_ticket_number"],
        "ss_sold_date_sk", "ss_item_sk", "ss_promo_sk",
        (t["store"], ["ss_store_sk"], ["s_store_sk"]), "s_store_id",
        "ss_ext_sales_price", "ss_net_profit", "sr_return_amt",
        "sr_net_loss", "store channel", "store")
    catalog_rows = channel(
        "catalog_sales", "catalog_returns",
        ["cs_item_sk", "cs_order_number"],
        ["cr_item_sk", "cr_order_number"],
        "cs_sold_date_sk", "cs_item_sk", "cs_promo_sk",
        (t["catalog_page"], ["cs_catalog_page_sk"],
         ["cp_catalog_page_sk"]), "cp_catalog_page_id",
        "cs_ext_sales_price", "cs_net_profit", "cr_return_amount",
        "cr_net_loss", "catalog channel", "catalog_page")
    web_rows = channel(
        "web_sales", "web_returns",
        ["ws_item_sk", "ws_order_number"],
        ["wr_item_sk", "wr_order_number"],
        "ws_sold_date_sk", "ws_item_sk", "ws_promo_sk",
        (t["web_site"], ["ws_web_site_sk"], ["web_site_sk"]),
        "web_site_id",
        "ws_ext_sales_price", "ws_net_profit", "wr_return_amt",
        "wr_net_loss", "web channel", "web_site")
    return _rollup_channel_tail(
        CpuUnion(store_rows, catalog_rows, web_rows))


QUERIES.update({"q5": q5, "q77": q77, "q80": q80})


def _q56_60_channel(t, sales, date_key, addr_key, item_key, val,
                    item_pred, year, moy):
    """q56/q60 channel CTE: per-item-id revenue for one month/offset,
    item-id semi-joined against a predicate item set."""
    ids = CpuProject(
        [col("sel_id")],
        CpuAggregate([col("i_item_id").alias("sel_id")],
                     [Count(None).alias("_c")],
                     CpuFilter(item_pred, t["item"])))
    it = _join(t["item"], ids, ["i_item_id"], ["sel_id"],
               jt=J.LEFT_SEMI)
    dd = CpuFilter((col("d_year") == lit(year)) &
                   (col("d_moy") == lit(moy)), t["date_dim"])
    ca = CpuFilter(col("ca_gmt_offset") == lit(-5.0),
                   t["customer_address"])
    j = _join(_join(_join(dd, sales, ["d_date_sk"], [date_key]),
                    ca, [addr_key], ["ca_address_sk"]),
              it, [item_key], ["i_item_sk"])
    return CpuAggregate([col("i_item_id")],
                        [Sum(col(val)).alias("total_sales")], j)


def q56(t, run):
    """Reference q56: revenue of chosen-color items by channel for one
    month, union re-aggregated."""
    pred = InSet(col("i_color"), ("slate", "powder", "khaki"))
    ss = _q56_60_channel(t, t["store_sales"], "ss_sold_date_sk",
                         "ss_addr_sk", "ss_item_sk",
                         "ss_ext_sales_price", pred, 2001, 2)
    cs = _q56_60_channel(t, t["catalog_sales"], "cs_sold_date_sk",
                         "cs_bill_addr_sk", "cs_item_sk",
                         "cs_ext_sales_price", pred, 2001, 2)
    ws = _q56_60_channel(t, t["web_sales"], "ws_sold_date_sk",
                         "ws_bill_addr_sk", "ws_item_sk",
                         "ws_ext_sales_price", pred, 2001, 2)
    agg = CpuAggregate([col("i_item_id")],
                       [Sum(col("total_sales")).alias("total_sales")],
                       CpuUnion(ss, cs, ws))
    return CpuLimit(100, CpuSort([asc(col("total_sales"))], agg))


def q60(t, run):
    """Reference q60: q56's shape for one category in 1998-09."""
    pred = InSet(col("i_category"), ("Music",))
    ss = _q56_60_channel(t, t["store_sales"], "ss_sold_date_sk",
                         "ss_addr_sk", "ss_item_sk",
                         "ss_ext_sales_price", pred, 1998, 9)
    cs = _q56_60_channel(t, t["catalog_sales"], "cs_sold_date_sk",
                         "cs_bill_addr_sk", "cs_item_sk",
                         "cs_ext_sales_price", pred, 1998, 9)
    ws = _q56_60_channel(t, t["web_sales"], "ws_sold_date_sk",
                         "ws_bill_addr_sk", "ws_item_sk",
                         "ws_ext_sales_price", pred, 1998, 9)
    agg = CpuAggregate([col("i_item_id")],
                       [Sum(col("total_sales")).alias("total_sales")],
                       CpuUnion(ss, cs, ws))
    return CpuLimit(100, CpuSort(
        [asc(col("i_item_id")), asc(col("total_sales"))], agg))


def q58(t, run):
    """Reference q58: items with near-equal revenue in all three
    channels for one chosen week."""
    wk = CpuProject(
        [col("d_week_seq").alias("sel_wk")],
        CpuAggregate(
            [col("d_week_seq")], [Count(None).alias("_c")],
            CpuFilter(col("d_date") == _date(2000, 6, 30),
                      t["date_dim"])))
    dates = CpuProject(
        [col("d_date_sk")],
        _join(t["date_dim"], wk, ["d_week_seq"], ["sel_wk"],
              jt=J.LEFT_SEMI))

    def rev(sales, date_key, item_key, val, alias):
        j = _join(_join(dates, sales, ["d_date_sk"], [date_key]),
                  t["item"], [item_key], ["i_item_sk"])
        return CpuAggregate([col("i_item_id")],
                            [Sum(col(val)).alias(alias)], j)

    ss = rev(t["store_sales"], "ss_sold_date_sk", "ss_item_sk",
             "ss_ext_sales_price", "ss_item_rev")
    cs = CpuProject(
        [col("i_item_id").alias("cs_id"), col("cs_item_rev")],
        rev(t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk",
            "cs_ext_sales_price", "cs_item_rev"))
    ws = CpuProject(
        [col("i_item_id").alias("ws_id"), col("ws_item_rev")],
        rev(t["web_sales"], "ws_sold_date_sk", "ws_item_sk",
            "ws_ext_sales_price", "ws_item_rev"))
    j = _join(_join(ss, cs, ["i_item_id"], ["cs_id"]),
              ws, ["i_item_id"], ["ws_id"])
    # reference band is 0.9..1.1; the synthetic weekly sums (and the
    # 2:1:0.5 channel volume ratio) need a wider stand-in band
    lo, hi = lit(0.02), lit(50.0)

    def near(a, b):
        return _between(col(a), lo * col(b), hi * col(b))
    f = CpuFilter(
        near("ss_item_rev", "cs_item_rev") &
        near("ss_item_rev", "ws_item_rev") &
        near("cs_item_rev", "ss_item_rev") &
        near("cs_item_rev", "ws_item_rev") &
        near("ws_item_rev", "ss_item_rev") &
        near("ws_item_rev", "cs_item_rev"), j)
    total = (col("ss_item_rev") + col("cs_item_rev") +
             col("ws_item_rev"))
    out = CpuProject(
        [col("i_item_id").alias("item_id"), col("ss_item_rev"),
         (col("ss_item_rev") / total / lit(3.0) *
          lit(100.0)).alias("ss_dev"),
         col("cs_item_rev"),
         (col("cs_item_rev") / total / lit(3.0) *
          lit(100.0)).alias("cs_dev"),
         col("ws_item_rev"),
         (col("ws_item_rev") / total / lit(3.0) *
          lit(100.0)).alias("ws_dev"),
         (total / lit(3.0)).alias("average")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("item_id")), asc(col("ss_item_rev"))], out))


def q54(t, run):
    """Reference q54: revenue segments of customers who bought the
    target class cross-channel, then shopped locally next quarter."""
    u = CpuUnion(
        CpuProject([col("cs_sold_date_sk").alias("sold_date_sk"),
                    col("cs_bill_customer_sk").alias("customer_sk"),
                    col("cs_item_sk").alias("item_sk")],
                   t["catalog_sales"]),
        CpuProject([col("ws_sold_date_sk").alias("sold_date_sk"),
                    col("ws_bill_customer_sk").alias("customer_sk"),
                    col("ws_item_sk").alias("item_sk")],
                   t["web_sales"]))
    # reference Women/maternity stands in as the generator class pool
    it = CpuFilter((col("i_category") == lit("Women")) &
                   InSet(col("i_class"), ("class00", "class01",
                                          "class02", "class03")),
                   t["item"])
    dd = CpuFilter((col("d_moy") == lit(12)) &
                   (col("d_year") == lit(1998)), t["date_dim"])
    j = _join(_join(_join(u, dd, ["sold_date_sk"], ["d_date_sk"]),
                    it, ["item_sk"], ["i_item_sk"]),
              t["customer"], ["customer_sk"], ["c_customer_sk"])
    my_customers = CpuProject(
        [col("c_customer_sk"), col("c_current_addr_sk")],
        CpuAggregate([col("c_customer_sk"),
                      col("c_current_addr_sk")],
                     [Count(None).alias("_n")], j))
    # month-seq window (1998-12 month_seq = 11): +1 .. +3
    seq = CpuProject(
        [(col("d_month_seq") + lit(1)).alias("lo_seq"),
         (col("d_month_seq") + lit(3)).alias("hi_seq"),
         lit(1).alias("_sk")],
        CpuAggregate(
            [col("d_month_seq")], [Count(None).alias("_c")],
            CpuFilter((col("d_year") == lit(1998)) &
                      (col("d_moy") == lit(12)), t["date_dim"])))
    dd2 = CpuFilter(
        _between(col("d_month_seq"), col("lo_seq"), col("hi_seq")),
        _join(CpuProject([col("d_date_sk"), col("d_month_seq"),
                          lit(1).alias("_dk")], t["date_dim"]),
              seq, ["_dk"], ["_sk"]))
    dd2 = CpuProject([col("d_date_sk")], dd2)
    j2 = _join(my_customers, t["store_sales"],
               ["c_customer_sk"], ["ss_customer_sk"])
    j2 = _join(j2, t["customer_address"], ["c_current_addr_sk"],
               ["ca_address_sk"])
    j2 = _join(j2, t["store"], ["ca_county", "ca_state"],
               ["s_county", "s_state"])
    j2 = _join(j2, dd2, ["ss_sold_date_sk"], ["d_date_sk"],
               jt=J.LEFT_SEMI)
    my_revenue = CpuAggregate(
        [col("c_customer_sk")],
        [Sum(col("ss_ext_sales_price")).alias("revenue")], j2)
    segments = CpuProject(
        [Cast(col("revenue") / lit(50.0), _T.INT64).alias("segment")],
        my_revenue)
    agg = CpuAggregate([col("segment")],
                       [Count(None).alias("num_customers")], segments)
    out = CpuProject(
        [col("segment"), col("num_customers"),
         (col("segment") * lit(50)).alias("segment_base")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col("segment")), asc(col("num_customers"))], out))


QUERIES.update({"q56": q56, "q60": q60, "q58": q58, "q54": q54})


def _q17_29_chain(t, d1_pred, d2_pred, d3_pred):
    """q17/q29 shared join chain: store sale -> its return -> the same
    customer's catalog purchase, each against its own date window."""
    d1 = CpuFilter(d1_pred, t["date_dim"])
    d2 = CpuProject([col("d_date_sk").alias("d2_sk")],
                    CpuFilter(d2_pred, t["date_dim"]))
    d3 = CpuProject([col("d_date_sk").alias("d3_sk")],
                    CpuFilter(d3_pred, t["date_dim"]))
    ss = _join(d1, t["store_sales"], ["d_date_sk"], ["ss_sold_date_sk"])
    sr = _join(d2, t["store_returns"], ["d2_sk"],
               ["sr_returned_date_sk"])
    cs = _join(d3, t["catalog_sales"], ["d3_sk"], ["cs_sold_date_sk"])
    j = _join(ss, sr,
              ["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
              ["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
    j = _join(j, cs, ["sr_customer_sk", "sr_item_sk"],
              ["cs_bill_customer_sk", "cs_item_sk"])
    j = _join(j, t["store"], ["ss_store_sk"], ["s_store_sk"])
    return _join(j, t["item"], ["ss_item_sk"], ["i_item_sk"])


def q17(t, run):
    """Reference q17: quantity count/mean/stddev/cov per item+state for
    sale -> return -> repurchase chains inside one quarter window."""
    # reference sale window is 2001Q1; the full year stands in for
    # the sparse synthetic sale->return->repurchase chains
    j = _q17_29_chain(
        t,
        col("d_year") == lit(2001),
        col("d_year") == lit(2001),
        col("d_year") == lit(2001))
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("s_state")],
        [Count(col("ss_quantity")).alias("store_sales_quantitycount"),
         Average(col("ss_quantity")).alias("store_sales_quantityave"),
         _Stddev(col("ss_quantity")).alias("store_sales_quantitystdev"),
         Count(col("sr_return_quantity")
               ).alias("store_returns_quantitycount"),
         Average(col("sr_return_quantity")
                 ).alias("store_returns_quantityave"),
         _Stddev(col("sr_return_quantity")
                 ).alias("store_returns_quantitystdev"),
         Count(col("cs_quantity")).alias("catalog_sales_quantitycount"),
         Average(col("cs_quantity")).alias("catalog_sales_quantityave"),
         _Stddev(col("cs_quantity")
                 ).alias("catalog_sales_quantitystdev")], j)
    out = CpuProject(
        [col("i_item_id"), col("i_item_desc"), col("s_state"),
         col("store_sales_quantitycount"),
         col("store_sales_quantityave"),
         col("store_sales_quantitystdev"),
         (col("store_sales_quantitystdev") /
          col("store_sales_quantityave")).alias("store_sales_cov"),
         col("store_returns_quantitycount"),
         col("store_returns_quantityave"),
         col("store_returns_quantitystdev"),
         (col("store_returns_quantitystdev") /
          col("store_returns_quantityave")).alias("store_returns_cov"),
         col("catalog_sales_quantitycount"),
         col("catalog_sales_quantityave"),
         (col("catalog_sales_quantitystdev") /
          col("catalog_sales_quantityave")).alias("catalog_sales_cov")],
        agg)
    return CpuLimit(100, CpuSort(
        [asc(col("i_item_id")), asc(col("i_item_desc")),
         asc(col("s_state"))], out))


def q29(t, run):
    """Reference q29: quantity totals for sale -> return -> repurchase
    chains across widening date windows."""
    # reference sale window is 1999-09; the full year stands in for
    # the sparse synthetic sale->return->repurchase chains
    j = _q17_29_chain(
        t,
        col("d_year") == lit(1999),
        _between(col("d_moy"), lit(1), lit(12)) &
        (col("d_year") == lit(1999)),
        InSet(col("d_year"), (1999, 2000, 2001)))
    agg = CpuAggregate(
        [col("i_item_id"), col("i_item_desc"), col("s_store_id"),
         col("s_store_name")],
        [Sum(col("ss_quantity")).alias("store_sales_quantity"),
         Sum(col("sr_return_quantity")).alias("store_returns_quantity"),
         Sum(col("cs_quantity")).alias("catalog_sales_quantity")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("i_item_id")), asc(col("i_item_desc")),
         asc(col("s_store_id")), asc(col("s_store_name"))], agg))


def _q39_inv(t):
    """q39 inv CTE: per warehouse/item/month inventory stdev & mean,
    kept when cov exceeds the (stand-in) threshold."""
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    j = _join(_join(_join(
        dd, t["inventory"], ["d_date_sk"], ["inv_date_sk"]),
        t["item"], ["inv_item_sk"], ["i_item_sk"]),
        t["warehouse"], ["inv_warehouse_sk"], ["w_warehouse_sk"])
    agg = CpuAggregate(
        [col("w_warehouse_name"), col("w_warehouse_sk"),
         col("i_item_sk"), col("d_moy")],
        [_Stddev(col("inv_quantity_on_hand")).alias("stdev"),
         Average(col("inv_quantity_on_hand")).alias("mean")], j)
    cov = If(col("mean") == lit(0.0), _Lit(None, _T.FLOAT64),
             col("stdev") / col("mean"))
    # reference cov > 1 can't fire on uniform synthetic quantities
    # (cov ~= 0.58); 0.5 stands in
    keep = If(col("mean") == lit(0.0), lit(0.0),
              col("stdev") / col("mean")) > lit(0.5)
    return CpuProject(
        [col("w_warehouse_sk"), col("i_item_sk"), col("d_moy"),
         col("mean"), cov.alias("cov")],
        CpuFilter(keep, agg))


def _q39_tail(t, extra_cov):
    inv = _q39_inv(t)
    inv1 = CpuFilter(col("d_moy") == lit(1), inv)
    if extra_cov:
        inv1 = CpuFilter(col("cov") > lit(0.52), inv1)
    inv1 = CpuProject(
        [col("w_warehouse_sk").alias("inv1_w"),
         col("i_item_sk").alias("inv1_i"),
         col("d_moy").alias("inv1_d_moy"),
         col("mean").alias("inv1_mean"), col("cov").alias("inv1_cov")],
        inv1)
    inv2 = CpuFilter(col("d_moy") == lit(2), inv)
    if extra_cov:
        inv2 = CpuFilter(col("cov") > lit(0.52), inv2)
    inv2 = CpuProject(
        [col("w_warehouse_sk").alias("inv2_w"),
         col("i_item_sk").alias("inv2_i"),
         col("d_moy").alias("inv2_d_moy"),
         col("mean").alias("inv2_mean"), col("cov").alias("inv2_cov")],
        inv2)
    j = _join(inv1, inv2, ["inv1_i", "inv1_w"], ["inv2_i", "inv2_w"])
    return CpuSort(
        [asc(col("inv1_w")), asc(col("inv1_i")),
         asc(col("inv1_d_moy")), asc(col("inv1_mean")),
         asc(col("inv1_cov")), asc(col("inv2_d_moy")),
         asc(col("inv2_mean")), asc(col("inv2_cov"))], j)


def q39(t, run):
    """Reference q39a: volatile-inventory item/warehouse pairs across
    consecutive months."""
    return _q39_tail(t, extra_cov=False)


def q39b(t, run):
    """Reference q39b: q39a restricted to the higher-cov slice."""
    return _q39_tail(t, extra_cov=True)


QUERIES.update({"q17": q17, "q29": q29, "q39": q39, "q39b": q39b})


def q95(t, run):
    """Reference q95: shipped web orders split across warehouses AND
    returned, with count-distinct order stats."""
    ws1k = CpuProject(
        [col("ws_order_number").alias("o1"),
         col("ws_warehouse_sk").alias("w1")], t["web_sales"])
    ws2k = CpuProject(
        [col("ws_order_number").alias("o2"),
         col("ws_warehouse_sk").alias("w2")], t["web_sales"])
    ws_wh = CpuFilter(col("w1") != col("w2"),
                      _join(ws1k, ws2k, ["o1"], ["o2"]))
    ws_wh = CpuProject(
        [col("o1")],
        CpuAggregate([col("o1")], [Count(None).alias("_n")], ws_wh))
    ret = _join(CpuProject([col("wr_order_number").alias("ro")],
                           t["web_returns"]),
                ws_wh, ["ro"], ["o1"], jt=J.LEFT_SEMI)
    ret = CpuProject(
        [col("ro")],
        CpuAggregate([col("ro")], [Count(None).alias("_n")], ret))
    dd = CpuFilter(_between(col("d_date"), _date(1999, 2, 1),
                            _date(1999, 4, 2)), t["date_dim"])
    ca = CpuFilter(col("ca_state") == lit("IL"),
                   t["customer_address"])
    web = CpuFilter(col("web_company_name") == lit("pri"),
                    t["web_site"])
    j = _join(dd, t["web_sales"], ["d_date_sk"], ["ws_ship_date_sk"])
    j = _join(j, ca, ["ws_ship_addr_sk"], ["ca_address_sk"])
    j = _join(j, web, ["ws_web_site_sk"], ["web_site_sk"])
    j = _join(j, ws_wh, ["ws_order_number"], ["o1"], jt=J.LEFT_SEMI)
    j = _join(j, ret, ["ws_order_number"], ["ro"], jt=J.LEFT_SEMI)
    sums = CpuAggregate(
        [], [Sum(col("ws_ext_ship_cost")).alias("total_ship_cost"),
             Sum(col("ws_net_profit")).alias("total_net_profit")],
        j)
    dist = CpuAggregate(
        [], [Count(None).alias("order_count")],
        CpuAggregate([col("ws_order_number")],
                     [Count(None).alias("_d")], j))
    both = _join(CpuProject([lit(1).alias("_ka"), col("order_count")],
                            dist),
                 CpuProject([lit(1).alias("_kb"),
                             col("total_ship_cost"),
                             col("total_net_profit")], sums),
                 ["_ka"], ["_kb"])
    return CpuLimit(100, CpuProject(
        [col("order_count"), col("total_ship_cost"),
         col("total_net_profit")], both))


def q72(t, run):
    """Reference q72: catalog orders that outstripped same-week
    inventory for one demographic, promo vs no-promo."""
    d1 = CpuProject([col("d_date_sk").alias("d1_sk"),
                     col("d_week_seq").alias("d1_wk"),
                     col("d_date").alias("d1_date")],
                    CpuFilter(col("d_year") == lit(1999),
                              t["date_dim"]))
    d2 = CpuProject([col("d_date_sk").alias("d2_sk"),
                     col("d_week_seq").alias("d2_wk")], t["date_dim"])
    d3 = CpuProject([col("d_date_sk").alias("d3_sk"),
                     col("d_date").alias("d3_date")], t["date_dim"])
    cd = CpuFilter(col("cd_marital_status") == lit("D"),
                   t["customer_demographics"])
    hd = CpuFilter(col("hd_buy_potential") == lit(">10000"),
                   t["household_demographics"])
    j = _join(t["catalog_sales"], t["inventory"],
              ["cs_item_sk"], ["inv_item_sk"])
    j = _join(j, t["warehouse"], ["inv_warehouse_sk"],
              ["w_warehouse_sk"])
    j = _join(j, t["item"], ["cs_item_sk"], ["i_item_sk"])
    j = _join(j, cd, ["cs_bill_cdemo_sk"], ["cd_demo_sk"])
    j = _join(j, hd, ["cs_bill_hdemo_sk"], ["hd_demo_sk"])
    j = _join(j, d1, ["cs_sold_date_sk"], ["d1_sk"])
    j = _join(j, d2, ["inv_date_sk"], ["d2_sk"])
    j = _join(j, d3, ["cs_ship_date_sk"], ["d3_sk"])
    pr = CpuProject([col("p_promo_sk")], t["promotion"])
    j = _join(j, pr, ["cs_promo_sk"], ["p_promo_sk"], jt=J.LEFT_OUTER)
    cr = CpuProject([col("cr_item_sk").alias("cri"),
                     col("cr_order_number").alias("cro")],
                    t["catalog_returns"])
    j = _join(j, cr, ["cs_item_sk", "cs_order_number"],
              ["cri", "cro"], jt=J.LEFT_OUTER)
    f = CpuFilter(
        (col("d1_wk") == col("d2_wk")) &
        (col("inv_quantity_on_hand") < col("cs_quantity")) &
        (Cast(col("d3_date"), _T.INT32) >
         Cast(col("d1_date"), _T.INT32) + lit(5)), j)
    agg = CpuAggregate(
        [col("i_item_desc"), col("w_warehouse_name"), col("d1_wk")],
        [Sum(If(IsNull(col("p_promo_sk")), lit(1),
                lit(0))).alias("no_promo"),
         Sum(If(IsNotNull(col("p_promo_sk")), lit(1),
                lit(0))).alias("promo"),
         Count(None).alias("total_cnt")], f)
    out = CpuProject(
        [col("i_item_desc"), col("w_warehouse_name"),
         col("d1_wk").alias("d_week_seq"), col("no_promo"),
         col("promo"), col("total_cnt")], agg)
    return CpuLimit(100, CpuSort(
        [desc(col("total_cnt")), asc(col("i_item_desc")),
         asc(col("w_warehouse_name")), asc(col("d_week_seq"))], out))


def _q66_channel(t, sales, date_key, time_key, ship_key, wh_key,
                 price, net):
    dd = CpuFilter(col("d_year") == lit(2001), t["date_dim"])
    td = CpuFilter(_between(col("t_time"), lit(30838),
                            lit(30838 + 28800)), t["time_dim"])
    # reference carriers DHL/BARIAN stand in as DHL/USPS
    sm = CpuFilter(InSet(col("sm_carrier"), ("DHL", "USPS")),
                   t["ship_mode"])
    j = _join(_join(_join(_join(
        dd, sales, ["d_date_sk"], [date_key]),
        td, [time_key], ["t_time_sk"]),
        sm, [ship_key], ["sm_ship_mode_sk"]),
        t["warehouse"], [wh_key], ["w_warehouse_sk"])

    months = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
              "sep", "oct", "nov", "dec"]
    aggs = []
    qty = {"ws_ext_sales_price": "ws_quantity",
           "ws_net_paid": "ws_quantity",
           "cs_ext_sales_price": "cs_quantity",
           "cs_net_paid": "cs_quantity"}
    for i, m in enumerate(months, start=1):
        aggs.append(Sum(If(col("d_moy") == lit(i),
                           col(price) * col(qty[price]),
                           lit(0.0))).alias(f"{m}_sales"))
    for i, m in enumerate(months, start=1):
        aggs.append(Sum(If(col("d_moy") == lit(i),
                           col(net) * col(qty[net]),
                           lit(0.0))).alias(f"{m}_net"))
    agg = CpuAggregate(
        [col("w_warehouse_name"), col("w_warehouse_sq_ft"),
         col("w_city"), col("w_county"), col("w_state"),
         col("w_country"), col("d_year")], aggs, j)
    return CpuProject(
        [col("w_warehouse_name"), col("w_warehouse_sq_ft"),
         col("w_city"), col("w_county"), col("w_state"),
         col("w_country"),
         lit("DHL,USPS").alias("ship_carriers"),
         col("d_year").alias("year")] +
        [col(f"{m}_sales") for m in months] +
        [col(f"{m}_net") for m in months], agg)


def q66(t, run):
    """Reference q66: warehouse monthly sales/net pivot across web and
    catalog channels for chosen carriers and a time-of-day band."""
    ws = _q66_channel(t, t["web_sales"], "ws_sold_date_sk",
                      "ws_sold_time_sk", "ws_ship_mode_sk",
                      "ws_warehouse_sk", "ws_ext_sales_price",
                      "ws_net_paid")
    cs = _q66_channel(t, t["catalog_sales"], "cs_sold_date_sk",
                      "cs_sold_time_sk", "cs_ship_mode_sk",
                      "cs_warehouse_sk", "cs_ext_sales_price",
                      "cs_net_paid")
    u = CpuUnion(ws, cs)
    months = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
              "sep", "oct", "nov", "dec"]
    aggs = ([Sum(col(f"{m}_sales")).alias(f"{m}_sales")
             for m in months] +
            [Sum(col(f"{m}_sales") /
                 col("w_warehouse_sq_ft")).alias(f"{m}_sales_per_sqft")
             for m in months] +
            [Sum(col(f"{m}_net")).alias(f"{m}_net") for m in months])
    agg = CpuAggregate(
        [col("w_warehouse_name"), col("w_warehouse_sq_ft"),
         col("w_city"), col("w_county"), col("w_state"),
         col("w_country"), col("ship_carriers"), col("year")],
        aggs, u)
    return CpuLimit(100, CpuSort([asc(col("w_warehouse_name"))], agg))


QUERIES.update({"q95": q95, "q72": q72, "q66": q66})


def q75(t, run):
    """Reference q75: net-of-returns category sales by item attrs,
    year-over-year decline (UNION distinct across channels)."""
    def detail(sales, returns, item_key, date_key, skeys, rkeys, qty,
               rqty, amt, ramt):
        it = CpuFilter(col("i_category") == lit("Books"), t["item"])
        j = _join(sales, it, [item_key], ["i_item_sk"])
        j = _join(j, t["date_dim"], [date_key], ["d_date_sk"])
        j = _join(j, returns, skeys, rkeys, jt=J.LEFT_OUTER)
        return CpuProject(
            [col("d_year"), col("i_brand_id"), col("i_class_id"),
             col("i_category_id"), col("i_manufact_id"),
             (col(qty) - Coalesce((col(rqty), lit(0)))
              ).alias("sales_cnt"),
             (col(amt) - Coalesce((col(ramt), lit(0.0)))
              ).alias("sales_amt")], j)

    u = CpuUnion(
        detail(t["catalog_sales"], t["catalog_returns"], "cs_item_sk",
               "cs_sold_date_sk",
               ["cs_order_number", "cs_item_sk"],
               ["cr_order_number", "cr_item_sk"],
               "cs_quantity", "cr_return_quantity",
               "cs_ext_sales_price", "cr_return_amount"),
        detail(t["store_sales"], t["store_returns"], "ss_item_sk",
               "ss_sold_date_sk",
               ["ss_ticket_number", "ss_item_sk"],
               ["sr_ticket_number", "sr_item_sk"],
               "ss_quantity", "sr_return_quantity",
               "ss_ext_sales_price", "sr_return_amt"),
        detail(t["web_sales"], t["web_returns"], "ws_item_sk",
               "ws_sold_date_sk",
               ["ws_order_number", "ws_item_sk"],
               ["wr_order_number", "wr_item_sk"],
               "ws_quantity", "wr_return_quantity",
               "ws_ext_sales_price", "wr_return_amt"))
    # UNION distinct: dedup the detail rows before re-aggregation
    cols = ["d_year", "i_brand_id", "i_class_id", "i_category_id",
            "i_manufact_id", "sales_cnt", "sales_amt"]
    dedup = CpuProject(
        [col(c) for c in cols],
        CpuAggregate([col(c) for c in cols],
                     [Count(None).alias("_n")], u))
    all_sales = CpuAggregate(
        [col("d_year"), col("i_brand_id"), col("i_class_id"),
         col("i_category_id"), col("i_manufact_id")],
        [Sum(col("sales_cnt")).alias("sales_cnt"),
         Sum(col("sales_amt")).alias("sales_amt")], dedup)
    curr = CpuFilter(col("d_year") == lit(2002), all_sales)
    prev = CpuProject(
        [col("d_year").alias("prev_year"),
         col("i_brand_id").alias("pb"), col("i_class_id").alias("pc"),
         col("i_category_id").alias("pg"),
         col("i_manufact_id").alias("pm"),
         col("sales_cnt").alias("prev_yr_cnt"),
         col("sales_amt").alias("prev_amt")],
        CpuFilter(col("d_year") == lit(2001), all_sales))
    j = _join(curr, prev,
              ["i_brand_id", "i_class_id", "i_category_id",
               "i_manufact_id"], ["pb", "pc", "pg", "pm"])
    f = CpuFilter(
        Cast(col("sales_cnt"), _T.FLOAT64) /
        Cast(col("prev_yr_cnt"), _T.FLOAT64) < lit(0.9), j)
    out = CpuProject(
        [col("prev_year"), col("d_year").alias("year"),
         col("i_brand_id"), col("i_class_id"), col("i_category_id"),
         col("i_manufact_id"), col("prev_yr_cnt"),
         col("sales_cnt").alias("curr_yr_cnt"),
         (col("sales_cnt") - col("prev_yr_cnt")
          ).alias("sales_cnt_diff"),
         (col("sales_amt") - col("prev_amt")).alias("sales_amt_diff")],
        f)
    return CpuLimit(100, CpuSort([asc(col("sales_cnt_diff"))], out))


def q78(t, run):
    """Reference q78: store-loyal purchases (never returned) vs the
    other channels per customer/item/year."""
    def chan(sales, returns, date_key, item_key, cust_key, skeys,
             rkeys, rnull, qty, wc, sp, tag):
        j = _join(t[sales], CpuProject(
            [col(rkeys[0]).alias("_r0"), col(rkeys[1]).alias("_r1")],
            t[returns]), skeys, ["_r0", "_r1"], jt=J.LEFT_OUTER)
        j = CpuFilter(IsNull(col("_r0")), j)
        j = _join(j, t["date_dim"], [date_key], ["d_date_sk"])
        return CpuAggregate(
            [col("d_year").alias(f"{tag}_sold_year"),
             col(item_key).alias(f"{tag}_item"),
             col(cust_key).alias(f"{tag}_cust")],
            [Sum(col(qty)).alias(f"{tag}_qty"),
             Sum(col(wc)).alias(f"{tag}_wc"),
             Sum(col(sp)).alias(f"{tag}_sp")], j)

    ws = chan("web_sales", "web_returns", "ws_sold_date_sk",
              "ws_item_sk", "ws_bill_customer_sk",
              ["ws_order_number", "ws_item_sk"],
              ["wr_order_number", "wr_item_sk"], "wr_order_number",
              "ws_quantity", "ws_wholesale_cost", "ws_sales_price",
              "ws")
    cs = chan("catalog_sales", "catalog_returns", "cs_sold_date_sk",
              "cs_item_sk", "cs_bill_customer_sk",
              ["cs_order_number", "cs_item_sk"],
              ["cr_order_number", "cr_item_sk"], "cr_order_number",
              "cs_quantity", "cs_wholesale_cost", "cs_sales_price",
              "cs")
    ss = chan("store_sales", "store_returns", "ss_sold_date_sk",
              "ss_item_sk", "ss_customer_sk",
              ["ss_ticket_number", "ss_item_sk"],
              ["sr_ticket_number", "sr_item_sk"], "sr_ticket_number",
              "ss_quantity", "ss_wholesale_cost", "ss_sales_price",
              "ss")
    j = _join(ss, ws, ["ss_sold_year", "ss_item", "ss_cust"],
              ["ws_sold_year", "ws_item", "ws_cust"], jt=J.LEFT_OUTER)
    j = _join(j, cs, ["ss_sold_year", "ss_item", "ss_cust"],
              ["cs_sold_year", "cs_item", "cs_cust"], jt=J.LEFT_OUTER)
    other_qty = (Coalesce((col("ws_qty"), lit(0))) +
                 Coalesce((col("cs_qty"), lit(0))))
    f = CpuFilter(
        ((Coalesce((col("ws_qty"), lit(0))) > lit(0)) |
         (Coalesce((col("cs_qty"), lit(0))) > lit(0))) &
        (col("ss_sold_year") == lit(2000)), j)
    out = CpuProject(
        [col("ss_sold_year"), col("ss_item").alias("ss_item_sk"),
         col("ss_cust").alias("ss_customer_sk"),
         Round(Cast(col("ss_qty"), _T.FLOAT64) /
               Cast(other_qty, _T.FLOAT64), 2).alias("ratio"),
         col("ss_qty").alias("store_qty"),
         col("ss_wc").alias("store_wholesale_cost"),
         col("ss_sp").alias("store_sales_price"),
         other_qty.alias("other_chan_qty"),
         (Coalesce((col("ws_wc"), lit(0.0))) +
          Coalesce((col("cs_wc"), lit(0.0)))
          ).alias("other_chan_wholesale_cost"),
         (Coalesce((col("ws_sp"), lit(0.0))) +
          Coalesce((col("cs_sp"), lit(0.0)))
          ).alias("other_chan_sales_price")], f)
    return CpuLimit(100, CpuSort(
        [asc(col("ss_sold_year")), asc(col("ss_item_sk")),
         asc(col("ss_customer_sk")), desc(col("store_qty")),
         desc(col("store_wholesale_cost")),
         desc(col("store_sales_price")), asc(col("other_chan_qty")),
         asc(col("other_chan_wholesale_cost")),
         asc(col("other_chan_sales_price"))], out))


QUERIES.update({"q75": q75, "q78": q78})


def _q24_ssales(t):
    """q24 ssales CTE: returned store purchases where the customer's
    birth country matches the (upper-cased) address country and the
    store shares the address zip."""
    st = CpuFilter(col("s_market_id") == lit(8), t["store"])
    j = _join(t["store_sales"], t["store_returns"],
              ["ss_ticket_number", "ss_item_sk"],
              ["sr_ticket_number", "sr_item_sk"])
    j = _join(j, st, ["ss_store_sk"], ["s_store_sk"])
    j = _join(j, t["item"], ["ss_item_sk"], ["i_item_sk"])
    j = _join(j, t["customer"], ["ss_customer_sk"], ["c_customer_sk"])
    ca = CpuProject(
        [Upper(col("ca_country")).alias("ca_country_up"),
         col("ca_zip").alias("ca_zip2"),
         col("ca_state").alias("ca_state")], t["customer_address"])
    j = _join(j, ca, ["c_birth_country", "s_zip"],
              ["ca_country_up", "ca_zip2"])
    return CpuAggregate(
        [col("c_last_name"), col("c_first_name"), col("s_store_name"),
         col("ca_state"), col("s_state"), col("i_color"),
         col("i_current_price"), col("i_manager_id"), col("i_units"),
         col("i_size")],
        [Sum(col("ss_net_paid")).alias("netpaid")], j)


def _q24_tail(t, color):
    ssales = _q24_ssales(t)
    thr = CpuProject(
        [(col("_a") * lit(0.05)).alias("threshold"),
         lit(1).alias("_tk")],
        CpuAggregate([], [Average(col("netpaid")).alias("_a")],
                     ssales))
    sel = CpuFilter(col("i_color") == lit(color), ssales)
    agg = CpuAggregate(
        [col("c_last_name"), col("c_first_name"), col("s_store_name")],
        [Sum(col("netpaid")).alias("paid")], sel)
    keyed = CpuProject(
        [col("c_last_name"), col("c_first_name"), col("s_store_name"),
         col("paid"), lit(1).alias("_pk")], agg)
    f = CpuFilter(col("paid") > col("threshold"),
                  _join(keyed, thr, ["_pk"], ["_tk"]))
    return CpuProject(
        [col("c_last_name"), col("c_first_name"), col("s_store_name"),
         col("paid")], f)


def q24(t, run):
    """Reference q24a: big spenders on one color at market-8 stores
    co-located with their address."""
    return _q24_tail(t, "snow")


def q24b(t, run):
    """Reference q24b: q24a for a second color."""
    return _q24_tail(t, "powder")


def _q23_ctes(t):
    """q23 CTEs: frequent same-day items and best store customers."""
    dd4 = CpuFilter(InSet(col("d_year"), (2000, 2001, 2002, 2003)),
                    t["date_dim"])
    j = _join(_join(dd4, t["store_sales"],
                    ["d_date_sk"], ["ss_sold_date_sk"]),
              t["item"], ["ss_item_sk"], ["i_item_sk"])
    freq = CpuAggregate(
        [_Substring(col("i_item_desc"), lit(1),
                    lit(30)).alias("itemdesc"),
         col("i_item_sk").alias("item_sk"),
         col("d_date").alias("solddate")],
        [Count(None).alias("cnt")], j)
    # reference keeps count > 4 per item-day; > 1 stands in at
    # synthetic scale
    freq = CpuProject(
        [col("item_sk")],
        CpuAggregate([col("item_sk")], [Count(None).alias("_n")],
                     CpuFilter(col("cnt") > lit(1), freq)))
    per_cust = CpuAggregate(
        [col("ss_customer_sk")],
        [Sum(col("ss_quantity") * col("ss_list_price")).alias("csales")],
        _join(dd4, t["store_sales"], ["d_date_sk"],
              ["ss_sold_date_sk"]))
    cmax = CpuProject(
        [(col("_m") * lit(0.5)).alias("cut"), lit(1).alias("_mk")],
        CpuAggregate(
            [], [Max(col("csales")).alias("_m")], per_cust))
    all_cust = CpuAggregate(
        [col("ss_customer_sk")],
        [Sum(col("ss_quantity") * col("ss_list_price")
             ).alias("ssales")], t["store_sales"])
    keyed = CpuProject(
        [col("ss_customer_sk"), col("ssales"), lit(1).alias("_ck")],
        all_cust)
    # reference threshold is 95% of the max customer's spend; 50%
    # stands in to keep a non-degenerate best-customer set
    best = CpuProject(
        [col("ss_customer_sk").alias("best_sk")],
        CpuFilter(col("ssales") > col("cut"),
                  _join(keyed, cmax, ["_ck"], ["_mk"])))
    return freq, best


def q23(t, run):
    """Reference q23a: Feb-2000 catalog+web revenue from the best store
    customers on frequently-sold items."""
    freq, best = _q23_ctes(t)
    dd = CpuFilter((col("d_year") == lit(2000)) &
                   (col("d_moy") == lit(2)), t["date_dim"])

    def chan(sales, date_key, item_key, cust_key, qty, lp):
        j = _join(dd, sales, ["d_date_sk"], [date_key])
        j = _join(j, freq, [item_key], ["item_sk"], jt=J.LEFT_SEMI)
        j = _join(j, best, [cust_key], ["best_sk"], jt=J.LEFT_SEMI)
        return CpuProject(
            [(col(qty) * col(lp)).alias("sales")], j)

    u = CpuUnion(
        chan(t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk",
             "cs_bill_customer_sk", "cs_quantity", "cs_list_price"),
        chan(t["web_sales"], "ws_sold_date_sk", "ws_item_sk",
             "ws_bill_customer_sk", "ws_quantity", "ws_list_price"))
    return CpuLimit(100, CpuAggregate(
        [], [Sum(col("sales")).alias("total_sales")], u))


def q23b(t, run):
    """Reference q23b: q23a broken out by best customer."""
    freq, best = _q23_ctes(t)
    dd = CpuFilter((col("d_year") == lit(2000)) &
                   (col("d_moy") == lit(2)), t["date_dim"])

    def chan(sales, date_key, item_key, cust_key, qty, lp):
        j = _join(dd, sales, ["d_date_sk"], [date_key])
        j = _join(j, freq, [item_key], ["item_sk"], jt=J.LEFT_SEMI)
        j = _join(j, best, [cust_key], ["best_sk"], jt=J.LEFT_SEMI)
        j = _join(j, t["customer"], [cust_key], ["c_customer_sk"])
        return CpuProject(
            [col("c_last_name"), col("c_first_name"),
             (col(qty) * col(lp)).alias("sales")], j)

    u = CpuUnion(
        chan(t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk",
             "cs_bill_customer_sk", "cs_quantity", "cs_list_price"),
        chan(t["web_sales"], "ws_sold_date_sk", "ws_item_sk",
             "ws_bill_customer_sk", "ws_quantity", "ws_list_price"))
    agg = CpuAggregate(
        [col("c_last_name"), col("c_first_name")],
        [Sum(col("sales")).alias("sales")], u)
    return CpuLimit(100, CpuSort(
        [asc(col("c_last_name")), asc(col("c_first_name")),
         asc(col("sales"))], agg))


QUERIES.update({"q24": q24, "q24b": q24b, "q23": q23, "q23b": q23b})


def _q14_cross_items(t):
    """q14 cross_items: items whose (brand, class, category) triple
    sold in ALL three channels in the 3-year window (INTERSECT as
    successive semi joins over the distinct triples)."""
    dd = CpuFilter(InSet(col("d_year"), (1999, 2000, 2001)),
                   t["date_dim"])

    def triples(sales, date_key, item_key, tag):
        j = _join(_join(dd, sales, ["d_date_sk"], [date_key]),
                  t["item"], [item_key], ["i_item_sk"])
        return CpuProject(
            [col("i_brand_id").alias(f"{tag}b"),
             col("i_class_id").alias(f"{tag}c"),
             col("i_category_id").alias(f"{tag}g")],
            CpuAggregate(
                [col("i_brand_id"), col("i_class_id"),
                 col("i_category_id")], [Count(None).alias("_n")], j))

    ss = triples(t["store_sales"], "ss_sold_date_sk", "ss_item_sk",
                 "s")
    cs = triples(t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk",
                 "c")
    ws = triples(t["web_sales"], "ws_sold_date_sk", "ws_item_sk", "w")
    both = _join(ss, cs, ["sb", "sc", "sg"], ["cb", "cc", "cg"],
                 jt=J.LEFT_SEMI)
    x = _join(both, ws, ["sb", "sc", "sg"], ["wb", "wc", "wg"],
              jt=J.LEFT_SEMI)
    items = _join(t["item"], x,
                  ["i_brand_id", "i_class_id", "i_category_id"],
                  ["sb", "sc", "sg"], jt=J.LEFT_SEMI)
    return CpuProject([col("i_item_sk").alias("cross_sk")], items)


def _q14_avg_sales(t):
    """q14 avg_sales scalar: mean quantity*list_price across the three
    channels over the window, keyed for a cross join."""
    dd = CpuFilter(InSet(col("d_year"), (1999, 2000, 2001)),
                   t["date_dim"])

    def chan(sales, date_key, qty, lp):
        j = _join(dd, sales, ["d_date_sk"], [date_key])
        return CpuProject(
            [(col(qty) * col(lp)).alias("qlp")], j)

    u = CpuUnion(
        chan(t["store_sales"], "ss_sold_date_sk", "ss_quantity",
             "ss_list_price"),
        chan(t["catalog_sales"], "cs_sold_date_sk", "cs_quantity",
             "cs_list_price"),
        chan(t["web_sales"], "ws_sold_date_sk", "ws_quantity",
             "ws_list_price"))
    return CpuProject(
        [col("average_sales"), lit(1).alias("_ak")],
        CpuAggregate([], [Average(col("qlp")).alias("average_sales")],
                     u))


def _q14_channel_sales(t, cross, avg, sales, date_key, item_key, qty,
                       lp, chan, date_pred):
    dd = CpuFilter(date_pred, t["date_dim"])
    j = _join(dd, t[sales], ["d_date_sk"], [date_key])
    j = _join(j, cross, [item_key], ["cross_sk"], jt=J.LEFT_SEMI)
    j = _join(j, t["item"], [item_key], ["i_item_sk"])
    agg = CpuAggregate(
        [col("i_brand_id"), col("i_class_id"), col("i_category_id")],
        [Sum(col(qty) * col(lp)).alias("sales"),
         Count(None).alias("number_sales")], j)
    keyed = CpuProject(
        [col("i_brand_id"), col("i_class_id"), col("i_category_id"),
         col("sales"), col("number_sales"), lit(1).alias("_hk")], agg)
    f = CpuFilter(col("sales") > col("average_sales"),
                  _join(keyed, avg, ["_hk"], ["_ak"]))
    return CpuProject(
        [lit(chan).alias("channel"), col("i_brand_id"),
         col("i_class_id"), col("i_category_id"), col("sales"),
         col("number_sales")], f)


def q14(t, run):
    """Reference q14a: above-average cross-channel triples for one
    month, totaled over ROLLUP(channel, brand, class, category)."""
    cross = _q14_cross_items(t)
    avg = _q14_avg_sales(t)
    pred = (col("d_year") == lit(2001)) & (col("d_moy") == lit(11))
    u = CpuUnion(
        _q14_channel_sales(t, cross, avg, "store_sales",
                           "ss_sold_date_sk", "ss_item_sk",
                           "ss_quantity", "ss_list_price", "store",
                           pred),
        _q14_channel_sales(t, cross, avg, "catalog_sales",
                           "cs_sold_date_sk", "cs_item_sk",
                           "cs_quantity", "cs_list_price", "catalog",
                           pred),
        _q14_channel_sales(t, cross, avg, "web_sales",
                           "ws_sold_date_sk", "ws_item_sk",
                           "ws_quantity", "ws_list_price", "web",
                           pred))
    keys = ["channel", "i_brand_id", "i_class_id", "i_category_id"]
    ex = _rollup_expand(u, keys, ["sales", "number_sales"])
    agg = CpuAggregate(
        [col(k) for k in keys] + [col("gid")],
        [Sum(col("sales")).alias("sum_sales"),
         Sum(col("number_sales")).alias("sum_number_sales")], ex)
    out = CpuProject(
        [col(k) for k in keys] +
        [col("sum_sales"), col("sum_number_sales")], agg)
    return CpuLimit(100, CpuSort(
        [asc(col(k)) for k in keys], out))


def q14b(t, run):
    """Reference q14b: this-week vs same-week-last-year store sales of
    cross-channel triples."""
    cross = _q14_cross_items(t)
    avg = _q14_avg_sales(t)

    def week_pred(year):
        wk = CpuProject(
            [col("d_week_seq").alias("sel_wk")],
            CpuAggregate(
                [col("d_week_seq")], [Count(None).alias("_c")],
                CpuFilter((col("d_year") == lit(year)) &
                          (col("d_moy") == lit(12)) &
                          (col("d_dom") == lit(11)), t["date_dim"])))
        return CpuProject(
            [col("d_date_sk")],
            _join(t["date_dim"], wk, ["d_week_seq"], ["sel_wk"],
                  jt=J.LEFT_SEMI))

    def store_week(dates, tag):
        j = _join(dates, t["store_sales"], ["d_date_sk"],
                  ["ss_sold_date_sk"])
        j = _join(j, cross, ["ss_item_sk"], ["cross_sk"],
                  jt=J.LEFT_SEMI)
        j = _join(j, t["item"], ["ss_item_sk"], ["i_item_sk"])
        agg = CpuAggregate(
            [col("i_brand_id"), col("i_class_id"),
             col("i_category_id")],
            [Sum(col("ss_quantity") * col("ss_list_price")
                 ).alias("sales"),
             Count(None).alias("number_sales")], j)
        keyed = CpuProject(
            [col("i_brand_id"), col("i_class_id"),
             col("i_category_id"), col("sales"), col("number_sales"),
             lit(1).alias("_hk")], agg)
        f = CpuFilter(col("sales") > col("average_sales"),
                      _join(keyed, avg, ["_hk"], ["_ak"]))
        return CpuProject(
            [col("i_brand_id").alias(f"{tag}_brand"),
             col("i_class_id").alias(f"{tag}_class"),
             col("i_category_id").alias(f"{tag}_cat"),
             col("sales").alias(f"{tag}_sales"),
             col("number_sales").alias(f"{tag}_number_sales")], f)

    this_year = store_week(week_pred(2000), "ty")
    last_year = store_week(week_pred(1999), "ly")
    j = _join(this_year, last_year,
              ["ty_brand", "ty_class", "ty_cat"],
              ["ly_brand", "ly_class", "ly_cat"])
    out = CpuProject(
        [lit("store").alias("ty_channel"),
         lit("store").alias("ly_channel"),
         col("ty_brand"), col("ly_brand").alias("ly_brand_id"),
         col("ty_cat"), col("ly_cat").alias("ly_cat_id"),
         col("ty_class"), col("ly_class").alias("ly_class_id"),
         col("ty_number_sales"), col("ly_number_sales"),
         col("ty_sales"), col("ly_sales")], j)
    return CpuLimit(100, CpuSort(
        [asc(col("ty_brand")), asc(col("ty_class")),
         asc(col("ty_cat"))], out))


QUERIES.update({"q14": q14, "q14b": q14b})


def q64(t, run):
    """Reference q64: repeat same-store purchases of profitable
    catalog-returned items, year over year, with buyer's sale-time and
    current demographics/addresses."""
    cs_ui = CpuFilter(
        col("sale") > lit(2.0) * col("refund"),
        CpuAggregate(
            [col("cs_item_sk")],
            [Sum(col("cs_ext_list_price")).alias("sale"),
             Sum(col("cr_refunded_cash") + col("cr_reversed_charge") +
                 col("cr_store_credit")).alias("refund")],
            _join(t["catalog_sales"], t["catalog_returns"],
                  ["cs_item_sk", "cs_order_number"],
                  ["cr_item_sk", "cr_order_number"])))
    cs_ui = CpuProject([col("cs_item_sk").alias("ui_sk")], cs_ui)

    it = CpuFilter(
        InSet(col("i_color"), ("floral", "deep", "light",
                               "cornflower", "midnight", "snow")) &
        _between(col("i_current_price"), lit(64.0), lit(74.0)) &
        _between(col("i_current_price"), lit(65.0), lit(79.0)),
        t["item"])
    cd1 = CpuProject([col("cd_demo_sk").alias("cd1_sk"),
                      col("cd_marital_status").alias("cd1_ms")],
                     t["customer_demographics"])
    cd2 = CpuProject([col("cd_demo_sk").alias("cd2_sk"),
                      col("cd_marital_status").alias("cd2_ms")],
                     t["customer_demographics"])
    hd1 = CpuProject([col("hd_demo_sk").alias("hd1_sk"),
                      col("hd_income_band_sk").alias("hd1_ib")],
                     t["household_demographics"])
    hd2 = CpuProject([col("hd_demo_sk").alias("hd2_sk"),
                      col("hd_income_band_sk").alias("hd2_ib")],
                     t["household_demographics"])
    ib1 = CpuProject([col("ib_income_band_sk").alias("ib1_sk")],
                     t["income_band"])
    ib2 = CpuProject([col("ib_income_band_sk").alias("ib2_sk")],
                     t["income_band"])
    ad1 = CpuProject(
        [col("ca_address_sk").alias("ad1_sk"),
         col("ca_street_number").alias("b_street_number"),
         col("ca_street_name").alias("b_street_name"),
         col("ca_city").alias("b_city"), col("ca_zip").alias("b_zip")],
        t["customer_address"])
    ad2 = CpuProject(
        [col("ca_address_sk").alias("ad2_sk"),
         col("ca_street_number").alias("c_street_number"),
         col("ca_street_name").alias("c_street_name"),
         col("ca_city").alias("c_city"), col("ca_zip").alias("c_zip")],
        t["customer_address"])
    d1 = CpuProject([col("d_date_sk").alias("d1_sk"),
                     col("d_year").alias("syear")], t["date_dim"])
    d2 = CpuProject([col("d_date_sk").alias("d2_sk"),
                     col("d_year").alias("fsyear")], t["date_dim"])
    d3 = CpuProject([col("d_date_sk").alias("d3_sk"),
                     col("d_year").alias("s2year")], t["date_dim"])

    j = _join(t["store_sales"], t["store_returns"],
              ["ss_item_sk", "ss_ticket_number"],
              ["sr_item_sk", "sr_ticket_number"])
    j = _join(j, cs_ui, ["ss_item_sk"], ["ui_sk"], jt=J.LEFT_SEMI)
    j = _join(j, t["store"], ["ss_store_sk"], ["s_store_sk"])
    j = _join(j, d1, ["ss_sold_date_sk"], ["d1_sk"])
    j = _join(j, t["customer"], ["ss_customer_sk"], ["c_customer_sk"])
    j = _join(j, cd1, ["ss_cdemo_sk"], ["cd1_sk"])
    j = _join(j, hd1, ["ss_hdemo_sk"], ["hd1_sk"])
    j = _join(j, ad1, ["ss_addr_sk"], ["ad1_sk"])
    j = _join(j, it, ["ss_item_sk"], ["i_item_sk"])
    j = _join(j, cd2, ["c_current_cdemo_sk"], ["cd2_sk"])
    j = _join(j, hd2, ["c_current_hdemo_sk"], ["hd2_sk"])
    j = _join(j, ad2, ["c_current_addr_sk"], ["ad2_sk"])
    j = _join(j, d2, ["c_first_sales_date_sk"], ["d2_sk"])
    j = _join(j, d3, ["c_first_shipto_date_sk"], ["d3_sk"])
    j = _join(j, CpuProject([col("p_promo_sk").alias("pk")],
                            t["promotion"]),
              ["ss_promo_sk"], ["pk"], jt=J.LEFT_SEMI)
    j = _join(j, ib1, ["hd1_ib"], ["ib1_sk"], jt=J.LEFT_SEMI)
    j = _join(j, ib2, ["hd2_ib"], ["ib2_sk"], jt=J.LEFT_SEMI)
    f = CpuFilter(col("cd1_ms") != col("cd2_ms"), j)
    groups = ["i_product_name", "i_item_sk", "s_store_name", "s_zip",
              "b_street_number", "b_street_name", "b_city", "b_zip",
              "c_street_number", "c_street_name", "c_city", "c_zip",
              "syear", "fsyear", "s2year"]
    cross_sales = CpuAggregate(
        [col(g) for g in groups],
        [Count(None).alias("cnt"),
         Sum(col("ss_wholesale_cost")).alias("s1"),
         Sum(col("ss_list_price")).alias("s2"),
         Sum(col("ss_coupon_amt")).alias("s3")], f)
    cs1 = CpuFilter(col("syear") == lit(1999), cross_sales)
    cs2 = CpuProject(
        [col("i_item_sk").alias("k_item"),
         col("s_store_name").alias("k_store"),
         col("s_zip").alias("k_zip"),
         col("cnt").alias("cs2_cnt"), col("s1").alias("cs2_s1"),
         col("s2").alias("cs2_s2"), col("s3").alias("cs2_s3"),
         col("syear").alias("cs2_syear")],
        CpuFilter(col("syear") == lit(2000), cross_sales))
    j2 = _join(cs1, cs2, ["i_item_sk", "s_store_name", "s_zip"],
               ["k_item", "k_store", "k_zip"])
    j2 = CpuFilter(col("cs2_cnt") <= col("cnt"), j2)
    out = CpuProject(
        [col("i_product_name").alias("product_name"),
         col("s_store_name").alias("store_name"),
         col("s_zip").alias("store_zip"), col("b_street_number"),
         col("b_street_name"), col("b_city"), col("b_zip"),
         col("c_street_number"), col("c_street_name"), col("c_city"),
         col("c_zip"), col("syear").alias("cs1_syear"),
         col("cnt").alias("cs1_cnt"), col("s1").alias("cs1_s1"),
         col("s2").alias("cs1_s2"), col("s3").alias("cs1_s3"),
         col("cs2_s1"), col("cs2_s2"), col("cs2_s3"),
         col("cs2_syear"), col("cs2_cnt")], j2)
    return CpuSort(
        [asc(col("product_name")), asc(col("store_name")),
         asc(col("cs2_cnt"))], out)


QUERIES.update({"q64": q64})
