"""16 of the 85 TPC-DS queries without a window or an expand
(part c of test_torch_tpcds_rest_[a-e].py, five files of about equal
time so that xdist's --dist loadfile spreads them), through
spark_rapids_tpu_torch's planner on the CPU, against spark_rapids_tpu's
CPU engine and the port's own CPU engine, with the fixtures and checks
of test_torch_tpcds.py (20,000 store_sales rows, seed 3, two
partitions).  q72 runs over its own tables of 2,000 store_sales rows
(seed 3): at the fixture's 20,000 its item-only join of catalog_sales
with inventory makes 8.5M pairs, and each CPU engine took ~50 s and
~18 GB on an 8-core box."""
import numpy as np
import pytest
from test_torch_tpcds import (check_query, one_torch_thread, ref_tables,
                              tables)

from spark_rapids_tpu.models import tpcds_data as RD
from spark_rapids_tpu_torch.models import tpcds_data as TD

#: the shared fixtures, named so that pytest finds them in this module
FIXTURES = (tables, ref_tables, one_torch_thread)

REST_QUERIES = [
    "q4", "q7", "q8", "q9", "q15", "q24b", "q25", "q31", "q42", "q54",
    "q56", "q68", "q74", "q83", "q85", "q99"
]


@pytest.mark.parametrize("name", REST_QUERIES)
def test_query_matches_reference(tables, ref_tables, name):
    check_query(name, tables, ref_tables)


def test_q72_matches_reference():
    """q72 over the generator's tables at 2,000 store_sales rows, seed 3,
    with check_query's checks."""
    small = TD.gen_tables(np.random.default_rng(3), 2000)
    ref_small = RD.gen_tables(np.random.default_rng(3), 2000)
    check_query("q72", small, ref_small)
