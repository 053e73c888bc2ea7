"""TPC-DS table synthetic data (port of spark_rapids_tpu/models/
tpcds_data.py, which gives the same frames from the same seed and
scale): the full 24-table catalog of the reference's TpcdsLikeSpark
readers, all three sales channels with their returns tables, inventory
and every dimension, generated in memory.

Dates use the TPC-DS surrogate-key convention (d_date_sk joins, d_year /
d_moy predicates).  Correlations the faithful query suite depends on at
test scale (all swept in round 3): zipf item popularity, December
holiday sales concentration, a three-week returns spike, county as a
function of state, stores sharing the address zip pool, weekly
inventory snapshots of the hot items, refunder == returner
demographics, and ~2% missing channel fks.
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T

SCHEMAS = {
    "date_dim": T.Schema.of(
        ("d_date_sk", T.INT64), ("d_year", T.INT32),
        ("d_moy", T.INT32), ("d_dom", T.INT32),
        ("d_day_name", T.STRING), ("d_qoy", T.INT32),
        ("d_dow", T.INT32), ("d_date", T.DATE32),
        ("d_month_seq", T.INT32), ("d_week_seq", T.INT32)),
    "item": T.Schema.of(
        ("i_item_sk", T.INT64), ("i_item_id", T.STRING),
        ("i_brand_id", T.INT32), ("i_brand", T.STRING),
        ("i_category_id", T.INT32), ("i_category", T.STRING),
        ("i_manufact_id", T.INT32), ("i_manager_id", T.INT32),
        ("i_current_price", T.FLOAT64), ("i_item_desc", T.STRING),
        ("i_class_id", T.INT32),
        ("i_class", T.STRING), ("i_manufact", T.STRING),
        ("i_product_name", T.STRING), ("i_color", T.STRING),
        ("i_units", T.STRING), ("i_size", T.STRING)),
    "store": T.Schema.of(
        ("s_store_sk", T.INT64), ("s_store_id", T.STRING),
        ("s_store_name", T.STRING), ("s_number_employees", T.INT32),
        ("s_city", T.STRING), ("s_state", T.STRING),
        ("s_county", T.STRING), ("s_gmt_offset", T.FLOAT64),
        ("s_company_id", T.INT32), ("s_company_name", T.STRING),
        ("s_market_id", T.INT32),
        ("s_street_number", T.STRING),
        ("s_street_name", T.STRING), ("s_street_type", T.STRING),
        ("s_suite_number", T.STRING), ("s_zip", T.STRING)),
    "customer": T.Schema.of(
        ("c_customer_sk", T.INT64), ("c_customer_id", T.STRING),
        ("c_first_name", T.STRING), ("c_last_name", T.STRING),
        ("c_current_addr_sk", T.INT64),
        ("c_current_cdemo_sk", T.INT64),
        ("c_current_hdemo_sk", T.INT64),
        ("c_birth_day", T.INT32),
        ("c_birth_month", T.INT32), ("c_birth_year", T.INT32),
        ("c_birth_country", T.STRING),
        ("c_preferred_cust_flag", T.STRING),
        ("c_salutation", T.STRING),
        ("c_login", T.STRING), ("c_email_address", T.STRING),
        ("c_last_review_date", T.STRING),
        ("c_first_sales_date_sk", T.INT64),
        ("c_first_shipto_date_sk", T.INT64)),
    "customer_address": T.Schema.of(
        ("ca_address_sk", T.INT64), ("ca_city", T.STRING),
        ("ca_state", T.STRING), ("ca_country", T.STRING),
        ("ca_zip", T.STRING), ("ca_county", T.STRING),
        ("ca_gmt_offset", T.FLOAT64),
        ("ca_street_number", T.STRING), ("ca_street_name", T.STRING),
        ("ca_street_type", T.STRING), ("ca_suite_number", T.STRING),
        ("ca_location_type", T.STRING)),
    "household_demographics": T.Schema.of(
        ("hd_demo_sk", T.INT64), ("hd_dep_count", T.INT32),
        ("hd_vehicle_count", T.INT32), ("hd_buy_potential", T.STRING),
        ("hd_income_band_sk", T.INT64)),
    "income_band": T.Schema.of(
        ("ib_income_band_sk", T.INT64), ("ib_lower_bound", T.INT32),
        ("ib_upper_bound", T.INT32)),
    "promotion": T.Schema.of(
        ("p_promo_sk", T.INT64), ("p_channel_email", T.STRING),
        ("p_channel_event", T.STRING), ("p_channel_dmail", T.STRING),
        ("p_channel_tv", T.STRING)),
    "store_sales": T.Schema.of(
        ("ss_sold_date_sk", T.INT64), ("ss_sold_time_sk", T.INT64),
        ("ss_item_sk", T.INT64),
        ("ss_customer_sk", T.INT64), ("ss_cdemo_sk", T.INT64),
        ("ss_hdemo_sk", T.INT64), ("ss_addr_sk", T.INT64),
        ("ss_store_sk", T.INT64), ("ss_promo_sk", T.INT64),
        ("ss_ticket_number", T.INT64), ("ss_quantity", T.INT32),
        ("ss_list_price", T.FLOAT64), ("ss_sales_price", T.FLOAT64),
        ("ss_ext_sales_price", T.FLOAT64),
        ("ss_ext_discount_amt", T.FLOAT64),
        ("ss_ext_list_price", T.FLOAT64),
        ("ss_coupon_amt", T.FLOAT64), ("ss_net_profit", T.FLOAT64),
        ("ss_ext_wholesale_cost", T.FLOAT64),
        ("ss_net_paid", T.FLOAT64),
        ("ss_wholesale_cost", T.FLOAT64)),
    "time_dim": T.Schema.of(
        ("t_time_sk", T.INT64), ("t_hour", T.INT32),
        ("t_minute", T.INT32), ("t_meal_time", T.STRING),
        ("t_time", T.INT32)),
    "customer_demographics": T.Schema.of(
        ("cd_demo_sk", T.INT64), ("cd_gender", T.STRING),
        ("cd_marital_status", T.STRING),
        ("cd_education_status", T.STRING), ("cd_dep_count", T.INT32),
        ("cd_purchase_estimate", T.INT32),
        ("cd_credit_rating", T.STRING),
        ("cd_dep_employed_count", T.INT32),
        ("cd_dep_college_count", T.INT32)),
    "warehouse": T.Schema.of(
        ("w_warehouse_sk", T.INT64), ("w_warehouse_name", T.STRING),
        ("w_state", T.STRING), ("w_warehouse_sq_ft", T.INT32),
        ("w_city", T.STRING), ("w_county", T.STRING),
        ("w_country", T.STRING)),
    "catalog_sales": T.Schema.of(
        ("cs_sold_date_sk", T.INT64), ("cs_sold_time_sk", T.INT64),
        ("cs_ship_date_sk", T.INT64),
        ("cs_bill_customer_sk", T.INT64), ("cs_bill_cdemo_sk", T.INT64),
        ("cs_item_sk", T.INT64), ("cs_order_number", T.INT64),
        ("cs_warehouse_sk", T.INT64), ("cs_promo_sk", T.INT64),
        ("cs_quantity", T.INT32), ("cs_list_price", T.FLOAT64),
        ("cs_sales_price", T.FLOAT64),
        ("cs_ext_sales_price", T.FLOAT64),
        ("cs_ext_discount_amt", T.FLOAT64),
        ("cs_ext_list_price", T.FLOAT64),
        ("cs_ext_ship_cost", T.FLOAT64), ("cs_net_profit", T.FLOAT64),
        ("cs_net_paid", T.FLOAT64),
        ("cs_ship_addr_sk", T.INT64), ("cs_bill_addr_sk", T.INT64),
        ("cs_ship_customer_sk", T.INT64),
        ("cs_call_center_sk", T.INT64),
        ("cs_ship_mode_sk", T.INT64), ("cs_coupon_amt", T.FLOAT64),
        ("cs_wholesale_cost", T.FLOAT64),
        ("cs_catalog_page_sk", T.INT64),
        ("cs_bill_hdemo_sk", T.INT64)),
    "web_sales": T.Schema.of(
        ("ws_sold_date_sk", T.INT64), ("ws_sold_time_sk", T.INT64),
        ("ws_ship_date_sk", T.INT64),
        ("ws_bill_customer_sk", T.INT64),
        ("ws_ship_customer_sk", T.INT64), ("ws_item_sk", T.INT64),
        ("ws_order_number", T.INT64), ("ws_warehouse_sk", T.INT64),
        ("ws_web_site_sk", T.INT64), ("ws_promo_sk", T.INT64),
        ("ws_quantity", T.INT32), ("ws_list_price", T.FLOAT64),
        ("ws_sales_price", T.FLOAT64),
        ("ws_ext_sales_price", T.FLOAT64),
        ("ws_ext_discount_amt", T.FLOAT64),
        ("ws_ext_list_price", T.FLOAT64),
        ("ws_ext_ship_cost", T.FLOAT64), ("ws_net_profit", T.FLOAT64),
        ("ws_net_paid", T.FLOAT64), ("ws_wholesale_cost", T.FLOAT64),
        ("ws_ship_addr_sk", T.INT64), ("ws_bill_addr_sk", T.INT64),
        ("ws_ship_hdemo_sk", T.INT64), ("ws_web_page_sk", T.INT64),
        ("ws_ship_mode_sk", T.INT64)),
    "store_returns": T.Schema.of(
        ("sr_returned_date_sk", T.INT64), ("sr_item_sk", T.INT64),
        ("sr_customer_sk", T.INT64), ("sr_ticket_number", T.INT64),
        ("sr_store_sk", T.INT64), ("sr_return_quantity", T.INT32),
        ("sr_return_amt", T.FLOAT64), ("sr_net_loss", T.FLOAT64),
        ("sr_reason_sk", T.INT64), ("sr_cdemo_sk", T.INT64)),
    "catalog_returns": T.Schema.of(
        ("cr_returned_date_sk", T.INT64), ("cr_item_sk", T.INT64),
        ("cr_order_number", T.INT64),
        ("cr_returning_customer_sk", T.INT64),
        ("cr_returning_addr_sk", T.INT64),
        ("cr_return_quantity", T.INT32),
        ("cr_return_amount", T.FLOAT64),
        ("cr_return_amt_inc_tax", T.FLOAT64),
        ("cr_refunded_cash", T.FLOAT64),
        ("cr_reversed_charge", T.FLOAT64),
        ("cr_store_credit", T.FLOAT64),
        ("cr_call_center_sk", T.INT64),
        ("cr_net_loss", T.FLOAT64),
        ("cr_catalog_page_sk", T.INT64)),
    "web_returns": T.Schema.of(
        ("wr_returned_date_sk", T.INT64), ("wr_item_sk", T.INT64),
        ("wr_order_number", T.INT64),
        ("wr_returning_customer_sk", T.INT64),
        ("wr_returning_addr_sk", T.INT64),
        ("wr_refunded_cdemo_sk", T.INT64),
        ("wr_returning_cdemo_sk", T.INT64),
        ("wr_refunded_addr_sk", T.INT64),
        ("wr_reason_sk", T.INT64), ("wr_fee", T.FLOAT64),
        ("wr_refunded_cash", T.FLOAT64),
        ("wr_net_loss", T.FLOAT64), ("wr_web_page_sk", T.INT64),
        ("wr_return_quantity", T.INT32), ("wr_return_amt", T.FLOAT64)),
    "inventory": T.Schema.of(
        ("inv_date_sk", T.INT64), ("inv_item_sk", T.INT64),
        ("inv_warehouse_sk", T.INT64),
        ("inv_quantity_on_hand", T.INT32)),
    "call_center": T.Schema.of(
        ("cc_call_center_sk", T.INT64), ("cc_call_center_id", T.STRING),
        ("cc_name", T.STRING), ("cc_county", T.STRING),
        ("cc_manager", T.STRING)),
    "ship_mode": T.Schema.of(
        ("sm_ship_mode_sk", T.INT64), ("sm_type", T.STRING),
        ("sm_carrier", T.STRING)),
    "web_site": T.Schema.of(
        ("web_site_sk", T.INT64), ("web_site_id", T.STRING),
        ("web_name", T.STRING), ("web_company_name", T.STRING)),
    "catalog_page": T.Schema.of(
        ("cp_catalog_page_sk", T.INT64),
        ("cp_catalog_page_id", T.STRING)),
    "web_page": T.Schema.of(
        ("wp_web_page_sk", T.INT64), ("wp_char_count", T.INT32)),
    "reason": T.Schema.of(
        ("r_reason_sk", T.INT64), ("r_reason_desc", T.STRING)),
}

COUNTIES = ["Williamson County", "Ziebach County", "Walker County",
            "Barrow County", "Daviess County"]

CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Music",
              "Shoes", "Sports", "Women"]
STATES = ["CA", "GA", "IL", "NY", "TX", "WA"]
CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]


def _q4(x):
    """Quantize money values to quarters (exact dyadic f64).  TPC-DS
    money columns are DECIMAL(7,2) in the reference, whose sums are
    exact; modeled as f64, cent-quantized values accumulate
    summation-order ulp drift, which silently splits float-sum ties in
    rank windows (q67/q70) between the engine's partial/merge order and
    the golden's sequential order.  Quarter-quantized values make every
    sum EXACT in f64 at test scale, restoring decimal-like
    order-independence."""
    return np.round(np.asarray(x) * 4.0) / 4.0


def _money(rng, lo, hi, n):
    return _q4(rng.uniform(lo, hi, n))


def _holiday_respike(rng, sold: np.ndarray, n_dates: int
                     ) -> np.ndarray:
    """Move ~10% of sales into December days (holiday concentration):
    same-week-across-years comparisons (q14b) need repeatable weekly
    mass, which uniform dates never give at test scale."""
    m = rng.random(len(sold)) < 0.10
    years = rng.integers(0, n_dates // 365, int(m.sum()))
    dec = years * 365 + rng.integers(341, 365, int(m.sum()))
    out = sold.copy()
    out[m] = dec
    return out


def _item_popularity(n_items: int) -> np.ndarray:
    """Zipf-ish sales popularity over items: a few hot items appear in
    every channel every week, which cross-channel per-item queries
    (q14/q23/q58) require for support at test scale."""
    w = 1.0 / (np.arange(n_items) + 3.0) ** 1.2
    return w / w.sum()


def gen_tables(rng: np.random.Generator, scale: int = 10_000
               ) -> dict[str, pd.DataFrame]:
    """`scale` ~ store_sales rows; dimensions scale down dbgen-style."""
    n_dates = 365 * 5  # 1998-2002
    n_items = max(scale // 20, 50)
    n_stores = max(scale // 2000, 4)
    n_cust = max(scale // 10, 100)
    n_addr = n_cust
    n_hd = 60
    n_promo = max(scale // 500, 10)

    sk = np.arange(n_dates, dtype=np.int64)
    date_dim = pd.DataFrame({
        "d_date_sk": sk,
        "d_year": (1998 + sk // 365).astype(np.int32),
        "d_moy": ((sk % 365) // 31 + 1).clip(1, 12).astype(np.int32),
        # day-of-month aligned with the 31-day moy blocks, so any
        # (year, moy, dom) triple exists every year
        "d_dom": (((sk % 365) % 31) + 1).astype(np.int32),
        "d_day_name": np.array(DAY_NAMES, dtype=object)[sk % 7],
        "d_qoy": (((sk % 365) // 92) + 1).clip(1, 4).astype(np.int32),
        "d_dow": (sk % 7).astype(np.int32),
        # days since unix epoch: 1998-01-01 is day 10227
        "d_date": (sk + 10227).astype(np.int32),
        "d_month_seq": ((sk // 365) * 12 +
                        ((sk % 365) // 31).clip(0, 11)).astype(np.int32),
        "d_week_seq": (sk // 7).astype(np.int32),
    })
    item = pd.DataFrame({
        "i_item_sk": np.arange(n_items, dtype=np.int64),
        "i_item_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(n_items)], dtype=object),
        "i_brand_id": rng.integers(1, 10, n_items).astype(np.int32),
        "i_brand": np.array(
            [f"brand#{rng.integers(1, 10)}" for _ in range(n_items)],
            dtype=object),
        "i_category_id": rng.integers(0, len(CATEGORIES),
                                      n_items).astype(np.int32),
        "i_category": np.array(CATEGORIES, dtype=object)[
            rng.integers(0, len(CATEGORIES), n_items)],
        # manufacturer cycles deterministically like manager (below)
        "i_manufact_id": ((np.arange(n_items) % 100) + 1
                          ).astype(np.int32),
        # manager cycles deterministically so every manager id owns a
        # slice of the zipf-hot head items (q19/q55/q71 filter on one)
        "i_manager_id": ((np.arange(n_items) % 40) + 1
                         ).astype(np.int32),
        # prices sweep the range deterministically so every price band
        # contains hot items (q37/q40/q64 band filters)
        "i_current_price": _q4(
            (np.arange(n_items) * 7.3) % 99 + 1.0 +
            rng.uniform(0, 0.99, n_items)),
        "i_item_desc": np.array(
            [f"Item description {i % 251}" for i in range(n_items)],
            dtype=object),
        "i_class_id": rng.integers(1, 17, n_items).astype(np.int32),
        "i_class": np.array(
            [f"class{i % 16:02d}" for i in
             rng.integers(0, 16, n_items)], dtype=object),
        "i_manufact": np.array(
            [f"manufact#{i}" for i in
             rng.integers(1, 100, n_items)], dtype=object),
        "i_product_name": np.array(
            [f"product{i:06d}" for i in range(n_items)], dtype=object),
        "i_color": np.array(
            ["floral", "deep", "light", "cornflower", "midnight",
             "snow", "powder", "khaki"], dtype=object)[
            rng.integers(0, 8, n_items)],
        "i_units": np.array(
            ["N/A", "Dozen", "Box", "Pound", "Ounce", "Oz"],
            dtype=object)[rng.integers(0, 6, n_items)],
        "i_size": np.array(
            ["petite", "large", "medium", "extra large", "small"],
            dtype=object)[rng.integers(0, 5, n_items)],
    })
    store = pd.DataFrame({
        "s_store_sk": np.arange(n_stores, dtype=np.int64),
        "s_store_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(n_stores)], dtype=object),
        "s_store_name": np.array(
            ["ese", "ought", "able", "pri", "bar", "anti"][:n_stores]
            * (n_stores // 6 + 1), dtype=object)[:n_stores],
        "s_number_employees": rng.integers(200, 301,
                                           n_stores).astype(np.int32),
        "s_city": np.array(CITIES, dtype=object)[
            rng.integers(0, len(CITIES), n_stores)],
        "s_state": np.array(STATES, dtype=object)[
            (_s_state_idx := rng.integers(0, len(STATES), n_stores))],
        "s_county": np.array(COUNTIES, dtype=object)[
            _s_state_idx % len(COUNTIES)],
        "s_gmt_offset": np.array([-5.0, -6.0, -7.0, -8.0])[
            np.arange(n_stores) % 4],
        "s_company_id": np.ones(n_stores, np.int32),
        "s_company_name": np.array(["Unknown"] * n_stores,
                                   dtype=object),
        "s_market_id": np.where(np.arange(n_stores) % 2 == 0, 8,
                                5).astype(np.int32),
        "s_street_number": np.array(
            [str(100 + i) for i in range(n_stores)], dtype=object),
        "s_street_name": np.array(
            ["Main", "Oak", "Park", "First", "Elm"], dtype=object)[
            np.arange(n_stores) % 5],
        "s_street_type": np.array(
            ["St", "Ave", "Blvd", "Rd", "Ln"], dtype=object)[
            np.arange(n_stores) % 5],
        "s_suite_number": np.array(
            [f"Suite {i * 10}" for i in range(n_stores)], dtype=object),
        # stores share the customer-address zip pool so zip-prefix
        # correlations (q8) have matches at small scale
        "s_zip": np.array(
            [f"{z:05d}" for z in
             rng.choice([85669, 86197, 88274, 83405, 86475, 85392,
                         85460, 80348, 81792, 10144, 60332, 47311],
                        n_stores)], dtype=object),
    })
    customer = pd.DataFrame({
        "c_customer_sk": np.arange(n_cust, dtype=np.int64),
        "c_customer_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(n_cust)], dtype=object),
        "c_first_name": np.array(
            [f"First{i % 97}" for i in range(n_cust)], dtype=object),
        "c_last_name": np.array(
            [f"Last{i % 89}" for i in range(n_cust)], dtype=object),
        "c_current_addr_sk": rng.integers(0, n_addr,
                                          n_cust).astype(np.int64),
        "c_current_cdemo_sk": rng.integers(0, 1000,
                                           n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(0, 60,
                                           n_cust).astype(np.int64),
        "c_birth_day": rng.integers(1, 29, n_cust).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, n_cust).astype(np.int32),
        "c_birth_year": rng.integers(1924, 1993,
                                     n_cust).astype(np.int32),
        "c_birth_country": np.array(
            ["UNITED STATES", "CANADA", "MEXICO", "GERMANY", "JAPAN"],
            dtype=object)[rng.integers(0, 5, n_cust)],
        "c_preferred_cust_flag": np.array(["N", "Y"], dtype=object)[
            rng.integers(0, 2, n_cust)],
        "c_salutation": np.array(
            ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"], dtype=object)[
            rng.integers(0, 5, n_cust)],
        "c_login": np.array(
            [f"login{i}" for i in range(n_cust)], dtype=object),
        "c_email_address": np.array(
            [f"c{i}@example.com" for i in range(n_cust)], dtype=object),
        "c_last_review_date": np.array(
            [str(2450000 + (i * 37) % 1500) for i in range(n_cust)],
            dtype=object),
        "c_first_sales_date_sk": rng.integers(
            0, n_dates, n_cust).astype(np.int64),
        "c_first_shipto_date_sk": rng.integers(
            0, n_dates, n_cust).astype(np.int64),
    })
    customer_address = pd.DataFrame({
        "ca_address_sk": np.arange(n_addr, dtype=np.int64),
        "ca_city": np.array(CITIES + ["Edgewood"], dtype=object)[
            rng.integers(0, len(CITIES) + 1, n_addr)],
        "ca_state": np.array(STATES, dtype=object)[
            (_ca_state_idx := rng.integers(0, len(STATES), n_addr))],
        "ca_country": np.array(["United States"] * n_addr, dtype=object),
        "ca_zip": np.array(
            [f"{z:05d}" for z in
             rng.choice([85669, 86197, 88274, 83405, 86475, 85392,
                         85460, 80348, 81792, 10144, 60332, 47311],
                        n_addr)], dtype=object),
        # county is a function of state (as in a real atlas), so
        # address<->store co-location joins (q54) have support
        "ca_county": np.array(COUNTIES, dtype=object)[
            _ca_state_idx % len(COUNTIES)],
        "ca_gmt_offset": np.array([-5.0, -6.0, -7.0, -8.0])[
            np.arange(n_addr) % 4],
        "ca_street_number": np.array(
            [str(100 + i % 900) for i in range(n_addr)], dtype=object),
        "ca_street_name": np.array(
            ["Main", "Oak", "Park", "First", "Elm"], dtype=object)[
            np.arange(n_addr) % 5],
        "ca_street_type": np.array(
            ["St", "Ave", "Blvd", "Rd", "Ln"], dtype=object)[
            np.arange(n_addr) % 5],
        "ca_suite_number": np.array(
            [f"Suite {(i * 10) % 500}" for i in range(n_addr)],
            dtype=object),
        "ca_location_type": np.array(
            ["apartment", "condo", "single family"], dtype=object)[
            np.arange(n_addr) % 3],
    })
    household_demographics = pd.DataFrame({
        "hd_demo_sk": np.arange(n_hd, dtype=np.int64),
        "hd_dep_count": rng.integers(0, 10, n_hd).astype(np.int32),
        "hd_vehicle_count": rng.integers(0, 5, n_hd).astype(np.int32),
        "hd_buy_potential": rng.choice(
            np.array(BUY_POTENTIAL, dtype=object), n_hd,
            p=[0.3, 0.15, 0.1, 0.1, 0.05, 0.3]),
        "hd_income_band_sk": rng.integers(0, 20, n_hd).astype(np.int64),
    })
    income_band = pd.DataFrame({
        "ib_income_band_sk": np.arange(20, dtype=np.int64),
        "ib_lower_bound": (np.arange(20) * 10_000).astype(np.int32),
        "ib_upper_bound": ((np.arange(20) + 1) * 10_000).astype(np.int32),
    })
    promotion = pd.DataFrame({
        "p_promo_sk": np.arange(n_promo, dtype=np.int64),
        "p_channel_email": np.array(["N", "Y"], dtype=object)[
            (rng.random(n_promo) < 0.12).astype(int)],
        "p_channel_event": np.array(["N", "Y"], dtype=object)[
            (rng.random(n_promo) < 0.12).astype(int)],
        "p_channel_dmail": np.array(["N", "Y"], dtype=object)[
            (rng.random(n_promo) < 0.5).astype(int)],
        "p_channel_tv": np.array(["N", "Y"], dtype=object)[
            (rng.random(n_promo) < 0.5).astype(int)],
    })
    n_times = 24 * 12  # 5-minute buckets
    n_cdemo = 1000
    n_wh = 5
    n = scale
    item_pop = _item_popularity(n_items)
    # a ticket (basket) belongs to exactly one customer, several items —
    # the invariant q68/q73's per-ticket aggregates group on
    tickets = rng.integers(0, max(n // 6, 1), n).astype(np.int64)
    ticket_cust = ((tickets * 7919) % n_cust).astype(np.int64)
    qty = rng.integers(1, 101, n).astype(np.int32)
    list_price = _money(rng, 1.0, 200.0, n)
    sales_price = _q4(list_price * rng.uniform(0.2, 1.0, n))
    store_sales = pd.DataFrame({
        "ss_sold_date_sk": _holiday_respike(
            rng, rng.integers(0, n_dates, n), n_dates
        ).astype(np.int64),
        "ss_sold_time_sk": rng.integers(0, n_times, n).astype(np.int64),
        "ss_item_sk": rng.choice(n_items, n,
                                 p=item_pop).astype(np.int64),
        "ss_customer_sk": ticket_cust,
        "ss_cdemo_sk": rng.integers(0, n_cdemo, n).astype(np.int64),
        "ss_hdemo_sk": rng.integers(0, n_hd, n).astype(np.int64),
        "ss_addr_sk": rng.integers(0, n_addr, n).astype(np.int64),
        "ss_store_sk": rng.integers(0, n_stores, n).astype(np.int64),
        "ss_promo_sk": rng.integers(0, n_promo, n).astype(np.int64),
        "ss_ticket_number": tickets,
        "ss_quantity": qty,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_sales_price": _q4(sales_price * qty),
        "ss_ext_discount_amt": _money(rng, 0.0, 100.0, n),
        "ss_ext_list_price": _q4(list_price * qty),
        "ss_coupon_amt": np.where(rng.random(n) < 0.2,
                                  _money(rng, 0.0, 50.0, n), 0.0),
        "ss_net_profit": _money(rng, -500.0, 500.0, n),
        "ss_ext_wholesale_cost": _money(rng, 1.0, 100.0, n),
        "ss_net_paid": _q4(sales_price * qty),
        "ss_wholesale_cost": _money(rng, 1.0, 100.0, n),
    })

    t_hours = (np.arange(n_times) // 12).astype(np.int32)
    time_dim = pd.DataFrame({
        "t_time_sk": np.arange(n_times, dtype=np.int64),
        "t_hour": t_hours,
        "t_minute": ((np.arange(n_times) % 12) * 5).astype(np.int32),
        "t_meal_time": pd.array(
            np.select([(t_hours >= 6) & (t_hours <= 8),
                       (t_hours >= 11) & (t_hours <= 13),
                       (t_hours >= 17) & (t_hours <= 19)],
                      ["breakfast", "lunch", "dinner"],
                      default=None), dtype=object),
        "t_time": (np.arange(n_times) * 300).astype(np.int32),
    })
    customer_demographics = pd.DataFrame({
        "cd_demo_sk": np.arange(n_cdemo, dtype=np.int64),
        "cd_gender": np.array(["M", "F"], dtype=object)[
            rng.integers(0, 2, n_cdemo)],
        # biased toward the values the query predicates name, so
        # multi-way demographic chains (q10/q35/q85/q91) stay non-empty
        # at test scale
        "cd_marital_status": rng.choice(
            np.array(["M", "S", "D", "W", "U"], dtype=object), n_cdemo,
            p=[0.3, 0.2, 0.2, 0.2, 0.1]),
        "cd_education_status": rng.choice(
            np.array(["Primary", "Secondary", "College", "2 yr Degree",
                      "4 yr Degree", "Advanced Degree", "Unknown"],
                     dtype=object), n_cdemo,
            p=[0.05, 0.05, 0.2, 0.15, 0.15, 0.2, 0.2]),
        "cd_dep_count": rng.integers(0, 7, n_cdemo).astype(np.int32),
        "cd_purchase_estimate": (rng.integers(1, 20, n_cdemo) * 500
                                 ).astype(np.int32),
        "cd_credit_rating": np.array(
            ["Low Risk", "Good", "High Risk", "Unknown"],
            dtype=object)[rng.integers(0, 4, n_cdemo)],
        "cd_dep_employed_count": rng.integers(
            0, 7, n_cdemo).astype(np.int32),
        "cd_dep_college_count": rng.integers(
            0, 7, n_cdemo).astype(np.int32),
    })
    warehouse = pd.DataFrame({
        "w_warehouse_sk": np.arange(n_wh, dtype=np.int64),
        "w_warehouse_name": np.array(
            [f"Warehouse {i}" for i in range(n_wh)], dtype=object),
        "w_state": np.array(STATES, dtype=object)[
            np.arange(n_wh) % len(STATES)],
        "w_warehouse_sq_ft": rng.integers(
            50_000, 1_000_000, n_wh).astype(np.int32),
        "w_city": np.array(CITIES, dtype=object)[
            np.arange(n_wh) % len(CITIES)],
        "w_county": np.array(COUNTIES, dtype=object)[
            np.arange(n_wh) % len(COUNTIES)],
        "w_country": np.array(["United States"] * n_wh, dtype=object),
    })


    def _channel_sales(n_rows, order_div):
        orders = rng.integers(0, max(n_rows // order_div, 1),
                              n_rows).astype(np.int64)
        cust = ((orders * 6271) % n_cust).astype(np.int64)
        q = rng.integers(1, 101, n_rows).astype(np.int32)
        lp = _money(rng, 1.0, 250.0, n_rows)
        sp = _q4(lp * rng.uniform(0.2, 1.0, n_rows))
        sold = _holiday_respike(
            rng, rng.integers(0, n_dates, n_rows), n_dates
        ).astype(np.int64)
        return orders, cust, q, lp, sp, sold

    nc = max(n // 2, 1)
    c_orders, c_cust, c_qty, c_lp, c_sp, c_sold = _channel_sales(nc, 5)
    # half the catalog rows repeat a store (customer, item) pair so
    # cross-channel joins (q25/q29/q97 shapes) have real matches
    take = rng.random(nc) < 0.5
    src_idx = rng.integers(0, n, nc)
    cs_cust = np.where(take, ticket_cust[src_idx], c_cust)
    cs_item = np.where(
        take, store_sales["ss_item_sk"].to_numpy()[src_idx],
        rng.choice(n_items, nc, p=item_pop)).astype(np.int64)
    catalog_sales = pd.DataFrame({
        "cs_sold_date_sk": c_sold,
        "cs_sold_time_sk": rng.integers(0, n_times, nc).astype(np.int64),
        # shipping lag 1..120 days (q62/q99-style bucketing)
        "cs_ship_date_sk": np.minimum(
            c_sold + rng.integers(1, 121, nc), n_dates - 1
        ).astype(np.int64),
        "cs_bill_customer_sk": cs_cust,
        "cs_bill_cdemo_sk": rng.integers(0, n_cdemo, nc).astype(np.int64),
        "cs_item_sk": cs_item,
        "cs_order_number": c_orders,
        "cs_warehouse_sk": rng.integers(0, n_wh, nc).astype(np.int64),
        "cs_promo_sk": rng.integers(0, n_promo, nc).astype(np.int64),
        "cs_quantity": c_qty,
        "cs_list_price": c_lp,
        "cs_sales_price": c_sp,
        "cs_ext_sales_price": _q4(c_sp * c_qty),
        "cs_ext_discount_amt": _money(rng, 0.0, 100.0, nc),
        "cs_ext_list_price": _q4(c_lp * c_qty),
        "cs_ext_ship_cost": _money(rng, 0.0, 40.0, nc),
        "cs_net_profit": _money(rng, -500.0, 500.0, nc),
        "cs_net_paid": _q4(c_sp * c_qty),
        "cs_ship_addr_sk": rng.integers(0, n_addr, nc).astype(np.int64),
        "cs_bill_addr_sk": rng.integers(0, n_addr, nc).astype(np.int64),
        "cs_ship_customer_sk": cs_cust,
        "cs_call_center_sk": rng.integers(0, 4, nc).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(0, 5, nc).astype(np.int64),
        "cs_coupon_amt": np.where(rng.random(nc) < 0.2,
                                  _money(rng, 0.0, 50.0, nc), 0.0),
        "cs_wholesale_cost": _money(rng, 1.0, 100.0, nc),
        "cs_catalog_page_sk": rng.integers(0, 20,
                                           nc).astype(np.int64),
        "cs_bill_hdemo_sk": rng.integers(0, n_hd, nc).astype(np.int64),
    })

    nw = max(n // 3, 1)
    w_orders, w_cust, w_qty, w_lp, w_sp, w_sold = _channel_sales(nw, 4)
    web_sales = pd.DataFrame({
        "ws_sold_date_sk": w_sold,
        "ws_sold_time_sk": rng.integers(0, n_times, nw).astype(np.int64),
        "ws_ship_date_sk": np.minimum(
            w_sold + rng.integers(1, 121, nw), n_dates - 1
        ).astype(np.int64),
        "ws_bill_customer_sk": w_cust,
        "ws_ship_customer_sk": w_cust,
        "ws_item_sk": rng.choice(n_items, nw,
                                 p=item_pop).astype(np.int64),
        "ws_order_number": w_orders,
        "ws_warehouse_sk": rng.integers(0, n_wh, nw).astype(np.int64),
        "ws_web_site_sk": rng.integers(0, 6, nw).astype(np.int64),
        "ws_promo_sk": rng.integers(0, n_promo, nw).astype(np.int64),
        "ws_quantity": w_qty,
        "ws_list_price": w_lp,
        "ws_sales_price": w_sp,
        "ws_ext_sales_price": _q4(w_sp * w_qty),
        "ws_ext_discount_amt": _money(rng, 0.0, 100.0, nw),
        "ws_ext_list_price": _q4(w_lp * w_qty),
        "ws_ext_ship_cost": _money(rng, 0.0, 40.0, nw),
        "ws_net_profit": _money(rng, -500.0, 500.0, nw),
        "ws_net_paid": _q4(w_sp * w_qty),
        "ws_wholesale_cost": _money(rng, 1.0, 100.0, nw),
        "ws_ship_addr_sk": rng.integers(0, n_addr, nw).astype(np.int64),
        "ws_bill_addr_sk": rng.integers(0, n_addr, nw).astype(np.int64),
        "ws_ship_hdemo_sk": rng.integers(0, n_hd, nw).astype(np.int64),
        "ws_web_page_sk": rng.integers(0, 10, nw).astype(np.int64),
        "ws_ship_mode_sk": rng.integers(0, 5, nw).astype(np.int64),
    })

    # returns are samples of sales rows: join keys always match a sale
    ridx = rng.choice(n, size=max(n // 10, 1), replace=False)
    rq = np.minimum(rng.integers(1, 20, len(ridx)).astype(np.int32),
                    qty[ridx])
    store_returns = pd.DataFrame({
        "sr_returned_date_sk": np.minimum(
            store_sales["ss_sold_date_sk"].to_numpy()[ridx]
            + rng.integers(1, 60, len(ridx)), n_dates - 1
        ).astype(np.int64),
        "sr_item_sk": store_sales["ss_item_sk"].to_numpy()[ridx],
        "sr_customer_sk": store_sales["ss_customer_sk"].to_numpy()[ridx],
        "sr_ticket_number":
            store_sales["ss_ticket_number"].to_numpy()[ridx],
        "sr_store_sk": store_sales["ss_store_sk"].to_numpy()[ridx],
        "sr_return_quantity": rq,
        "sr_return_amt": _q4(
            store_sales["ss_sales_price"].to_numpy()[ridx] * rq),
        "sr_net_loss": _money(rng, 0.0, 200.0, len(ridx)),
        "sr_reason_sk": rng.integers(0, 10, len(ridx)).astype(np.int64),
        "sr_cdemo_sk": store_sales["ss_cdemo_sk"].to_numpy()[ridx],
    })

    call_center = pd.DataFrame({
        "cc_call_center_sk": np.arange(4, dtype=np.int64),
        "cc_call_center_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(4)], dtype=object),
        "cc_name": np.array(["NY Metro", "Mid Atlantic", "North Midwest",
                             "California"], dtype=object),
        "cc_county": np.array(COUNTIES, dtype=object)[
            rng.integers(0, len(COUNTIES), 4)],
        "cc_manager": np.array([f"Manager{i}" for i in range(4)],
                               dtype=object),
    })
    ship_mode = pd.DataFrame({
        "sm_ship_mode_sk": np.arange(5, dtype=np.int64),
        "sm_type": np.array(["EXPRESS", "NEXT DAY", "OVERNIGHT",
                             "REGULAR", "LIBRARY"], dtype=object),
        "sm_carrier": np.array(["UPS", "FEDEX", "AIRBORNE", "USPS",
                                "DHL"], dtype=object),
    })
    web_site = pd.DataFrame({
        "web_site_sk": np.arange(6, dtype=np.int64),
        "web_site_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(6)], dtype=object),
        "web_name": np.array([f"site_{i}" for i in range(6)],
                             dtype=object),
        "web_company_name": np.array(
            ["pri", "able", "ese", "ought", "anti", "cally"],
            dtype=object),
    })
    catalog_page = pd.DataFrame({
        "cp_catalog_page_sk": np.arange(20, dtype=np.int64),
        "cp_catalog_page_id": np.array(
            [f"AAAAAAAA{i:08d}" for i in range(20)], dtype=object),
    })
    web_page = pd.DataFrame({
        "wp_web_page_sk": np.arange(10, dtype=np.int64),
        "wp_char_count": rng.integers(100, 8000, 10).astype(np.int32),
    })
    reason = pd.DataFrame({
        "r_reason_sk": np.arange(10, dtype=np.int64),
        "r_reason_desc": np.array(
            [f"reason {i}" for i in range(10)], dtype=object),
    })
    cidx = rng.choice(nc, size=max(nc // 10, 1), replace=False)
    crq = np.minimum(rng.integers(1, 20, len(cidx)).astype(np.int32),
                     c_qty[cidx])
    catalog_returns = pd.DataFrame({
        "cr_returned_date_sk": np.minimum(
            c_sold[cidx] + rng.integers(1, 60, len(cidx)), n_dates - 1
        ).astype(np.int64),
        "cr_item_sk": catalog_sales["cs_item_sk"].to_numpy()[cidx],
        "cr_order_number": c_orders[cidx],
        "cr_returning_customer_sk": cs_cust[cidx],
        "cr_returning_addr_sk":
            catalog_sales["cs_bill_addr_sk"].to_numpy()[cidx],
        "cr_return_quantity": crq,
        "cr_return_amount": _q4(c_sp[cidx] * crq),
        "cr_return_amt_inc_tax": _q4(
            c_sp[cidx] * crq * 1.08),
        "cr_refunded_cash": _q4(
            c_sp[cidx] * crq * rng.uniform(0.5, 1.0, len(cidx))),
        "cr_reversed_charge": _money(rng, 0.0, 30.0, len(cidx)),
        "cr_store_credit": _money(rng, 0.0, 30.0, len(cidx)),
        "cr_call_center_sk": rng.integers(0, 4,
                                          len(cidx)).astype(np.int64),
        "cr_net_loss": _money(rng, 0.0, 200.0, len(cidx)),
        "cr_catalog_page_sk":
            catalog_sales["cs_catalog_page_sk"].to_numpy()[cidx],
    })
    widx = rng.choice(nw, size=max(nw // 6, 1), replace=False)
    wrq = np.minimum(rng.integers(1, 20, len(widx)).astype(np.int32),
                     w_qty[widx])
    web_returns = pd.DataFrame({
        "wr_returned_date_sk": np.minimum(
            w_sold[widx] + rng.integers(1, 60, len(widx)), n_dates - 1
        ).astype(np.int64),
        "wr_item_sk": web_sales["ws_item_sk"].to_numpy()[widx],
        "wr_order_number": w_orders[widx],
        "wr_returning_customer_sk": w_cust[widx],
        "wr_returning_addr_sk":
            web_sales["ws_bill_addr_sk"].to_numpy()[widx],
        "wr_refunded_cdemo_sk": (wr_cdemo := rng.integers(
            0, n_cdemo, len(widx)).astype(np.int64)),
        # the refunding customer usually IS the returning customer, so
        # matched-demographics predicates (q85) keep support
        "wr_returning_cdemo_sk": np.where(
            rng.random(len(widx)) < 0.9, wr_cdemo,
            rng.integers(0, n_cdemo, len(widx))).astype(np.int64),
        "wr_refunded_addr_sk":
            web_sales["ws_ship_addr_sk"].to_numpy()[widx],
        "wr_reason_sk": rng.integers(0, 10,
                                     len(widx)).astype(np.int64),
        "wr_fee": _money(rng, 0.0, 100.0, len(widx)),
        "wr_net_loss": _money(rng, 0.0, 200.0, len(widx)),
        "wr_web_page_sk":
            web_sales["ws_web_page_sk"].to_numpy()[widx],
        "wr_refunded_cash": _q4(
            w_sp[widx] * wrq * rng.uniform(0.5, 1.0, len(widx))),
        "wr_return_quantity": wrq,
        "wr_return_amt": _q4(w_sp[widx] * wrq),
    })

    # cluster ~30% of returns into three "returns spike" weeks (the
    # weeks of 2000-06-30 / 09-27 / 11-17, i.e. q83's selected weeks):
    # cross-channel per-item return intersections over short date
    # windows need shared mass, which independent uniform dates never
    # produce at test scale
    spike_days = np.concatenate([np.arange(7 * w, 7 * w + 7)
                                 for w in (130, 142, 150)])
    for frame, cname in ((store_returns, "sr_returned_date_sk"),
                         (catalog_returns, "cr_returned_date_sk"),
                         (web_returns, "wr_returned_date_sk")):
        m = rng.random(len(frame)) < 0.3
        frame.loc[m, cname] = rng.choice(spike_days, int(m.sum()))

    # inventory = weekly snapshots of the hot items across every
    # warehouse (the real table is a periodic full cross product, which
    # per-month dispersion stats like q39 require), plus a uniform
    # random tail for breadth
    snap_items = max(n_items // 20, 10)
    weeks = np.arange(0, n_dates, 7, dtype=np.int64)
    snap = np.stack(np.meshgrid(weeks,
                                np.arange(snap_items, dtype=np.int64),
                                np.arange(n_wh, dtype=np.int64),
                                indexing="ij"), -1).reshape(-1, 3)
    ni = max(n // 4, 1)
    inventory = pd.DataFrame({
        "inv_date_sk": np.concatenate(
            [snap[:, 0], rng.integers(0, n_dates, ni)]).astype(
            np.int64),
        "inv_item_sk": np.concatenate(
            [snap[:, 1], rng.integers(0, n_items, ni)]).astype(
            np.int64),
        "inv_warehouse_sk": np.concatenate(
            [snap[:, 2], rng.integers(0, n_wh, ni)]).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(
            0, 1000, len(snap) + ni).astype(np.int32),
    })

    # ~2% missing fks in each channel's "null channel-id" column (the
    # q76 shape groups on them; returns tables were sampled above from
    # the pre-null values so their keys still always match a sale)
    for frame, cname in ((store_sales, "ss_store_sk"),
                         (store_sales, "ss_addr_sk"),
                         (web_sales, "ws_ship_customer_sk"),
                         (catalog_sales, "cs_ship_addr_sk")):
        vals = frame[cname].to_numpy()
        na = rng.random(len(vals)) < 0.02
        frame[cname] = pd.array(np.where(na, 0, vals), dtype="Int64")
        frame.loc[na, cname] = pd.NA

    return {"date_dim": date_dim, "item": item, "store": store,
            "income_band": income_band,
            "customer": customer, "customer_address": customer_address,
            "household_demographics": household_demographics,
            "promotion": promotion, "store_sales": store_sales,
            "time_dim": time_dim,
            "customer_demographics": customer_demographics,
            "warehouse": warehouse, "catalog_sales": catalog_sales,
            "web_sales": web_sales, "store_returns": store_returns,
            "catalog_returns": catalog_returns,
            "web_returns": web_returns, "inventory": inventory,
            "call_center": call_center, "ship_mode": ship_mode,
            "web_site": web_site, "web_page": web_page,
            "catalog_page": catalog_page,
            "reason": reason}


def sources(tables: dict[str, pd.DataFrame], num_partitions: int = 1):
    from spark_rapids_tpu_torch.models.data_util import make_sources
    return make_sources(tables, SCHEMAS, num_partitions)
