"""16 of the 85 TPC-DS queries without a window or an expand
(part a of test_torch_tpcds_rest_[a-e].py, five files of about equal
time so that xdist's --dist loadfile spreads them), through
spark_rapids_tpu_torch's planner on the CPU, against spark_rapids_tpu's
CPU engine and the port's own CPU engine, with the fixtures and checks
of test_torch_tpcds.py (20,000 store_sales rows, seed 3, two
partitions).  q96 also goes against the reference's accelerated path.
The last test holds the five files to the 85."""
import pytest
from test_torch_tpcds import (check_query, one_torch_thread, ref_tables,
                              tables)

#: the shared fixtures, named so that pytest finds them in this module
FIXTURES = (tables, ref_tables, one_torch_thread)

REST_QUERIES = [
    "q12", "q19", "q23b", "q24", "q29", "q35", "q39b", "q64", "q71", "q76",
    "q79", "q81", "q84", "q87", "q94", "q96"
]


@pytest.mark.parametrize("name", REST_QUERIES)
def test_query_matches_reference(tables, ref_tables, name):
    check_query(name, tables, ref_tables)


def test_the_five_files_hold_the_other_85():
    """test_torch_tpcds_rest_[a-e].py hold every query of the registry
    but the 18 of test_torch_tpcds.py and test_torch_tpcds_rollup.py,
    each once (q72 in its own test of test_torch_tpcds_rest_c.py)."""
    import importlib

    from test_torch_tpcds import WINDOW_QUERIES
    from test_torch_tpcds_rollup import ROLLUP_QUERIES

    from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
    held = ["q72"]
    for part in "abcde":
        held += importlib.import_module(
            f"test_torch_tpcds_rest_{part}").REST_QUERIES
    assert len(held) == len(set(held)) == 85
    assert set(held) | set(WINDOW_QUERIES) | set(ROLLUP_QUERIES) == \
        set(QUERIES)
