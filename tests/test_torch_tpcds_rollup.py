"""The eight TPC-DS queries of the slice without a window, each a ROLLUP
through an expand, five with a UNION ALL (q5, q14, q18, q22, q27, q77,
q80, q86), through spark_rapids_tpu_torch's planner on the CPU, against
spark_rapids_tpu's CPU engine and the port's own CPU engine, with the
fixtures and checks of test_torch_tpcds.py (a file of its own so that
xdist can run it on another worker).  q86 and q5 also go against the
reference's accelerated path."""
import pytest
from test_torch_tpcds import (check_query, one_torch_thread, ref_tables,
                              tables)

#: the shared fixtures, named so that pytest finds them in this module
FIXTURES = (tables, ref_tables, one_torch_thread)

ROLLUP_QUERIES = ["q5", "q14", "q18", "q22", "q27", "q77", "q80", "q86"]


@pytest.mark.parametrize("name", ROLLUP_QUERIES)
def test_rollup_query_matches_reference(tables, ref_tables, name):
    check_query(name, tables, ref_tables)
