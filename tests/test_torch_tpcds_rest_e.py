"""18 of the 85 TPC-DS queries without a window or an expand
(part e of test_torch_tpcds_rest_[a-e].py, five files of about equal
time so that xdist's --dist loadfile spreads them), through
spark_rapids_tpu_torch's planner on the CPU, against spark_rapids_tpu's
CPU engine and the port's own CPU engine, with the fixtures and checks
of test_torch_tpcds.py (20,000 store_sales rows, seed 3, two
partitions)."""
import pytest
from test_torch_tpcds import (check_query, one_torch_thread, ref_tables,
                              tables)

#: the shared fixtures, named so that pytest finds them in this module
FIXTURES = (tables, ref_tables, one_torch_thread)

REST_QUERIES = [
    "q2", "q11", "q13", "q14b", "q26", "q32", "q39", "q40", "q46", "q48",
    "q50", "q52", "q62", "q63", "q66", "q69", "q97", "q98"
]


@pytest.mark.parametrize("name", REST_QUERIES)
def test_query_matches_reference(tables, ref_tables, name):
    check_query(name, tables, ref_tables)
