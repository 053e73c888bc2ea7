"""The 18 TPC-DS queries that need a window, a ROLLUP (an expand) or a
UNION ALL, as CPU plan trees (port of spark_rapids_tpu/models/
tpcds_queries.py, in the DSL of tpch_queries.py).

Each query is `fn(t, run) -> CpuNode`: `t` maps table name -> a fresh
source plan (`tpcds_data.sources`), `run(plan) -> DataFrame` executes a
sub-plan on the engine under test (none of these 18 calls it).  Every
plan is built as the reference builds it, from the reference suite's
query text over the generator's schemas (no decimals: money is
float64); where a reference literal has no support in the synthetic
data, the reference's stand-in literal is kept and commented at the
site.  ROLLUP lowers to a CpuExpand with one projection per key prefix
and a grouping id (`_rollup_expand`), as Spark's planner feeds
ExpandExec.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as _T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exec.window import (CpuWindow, Rank, WinAvg,
                                                WindowFrame, WindowSpec,
                                                WinMax, WinSum)
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.exprs.arithmetic import Abs as _Abs
from spark_rapids_tpu_torch.exprs.base import Literal as _Lit
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import Coalesce, If
from spark_rapids_tpu_torch.exprs.predicates import InSet, IsNotNull, IsNull
from spark_rapids_tpu_torch.exprs.string_fns import ConcatStrings
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuExpand,
                                               CpuFilter, CpuHashJoin,
                                               CpuLimit, CpuProject, CpuSort,
                                               CpuUnion)

J = JoinType


def _join(left, right, lk, rk, jt=J.INNER, condition=None):
    return CpuHashJoin(jt, [col(k) for k in lk], [col(k) for k in rk],
                       left, right, condition=condition)


def _date(y, m, d):
    """DATE32 literal: days since unix epoch."""
    import datetime
    days = (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    return _Lit(days, _T.DATE32)


def _between(c, lo, hi):
    return (c >= lo) & (c <= hi)


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


QUERIES = {
    "q5": q5, "q14": q14, "q18": q18, "q22": q22_rollup, "q27": q27,
    "q36": q36, "q44": q44, "q47": q47, "q49": q49, "q51": q51,
    "q53": q53, "q57": q57, "q67": q67, "q70": q70, "q77": q77,
    "q80": q80, "q86": q86_rollup, "q89": q89,
}
