"""spark_rapids_tpu_torch.ops.sort_encode against spark_rapids_tpu's: the
same keys (nulls, NaN, -0.0 in float32, padding rows) must give the same
permutation, segment boundaries and compacted positions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.vector import ColumnVector as RVector
from spark_rapids_tpu.ops import sort_encode as RS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.ops import sort_encode as S

N, CAP = 900, 1024


def _columns(seed):
    rng = np.random.default_rng(seed)
    i32 = rng.integers(-5, 5, N).astype(np.int32)
    f32 = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan, 7.25],
                              np.float32), N)
    i64 = rng.choice(np.array([-(1 << 40), -3, 0, 3, 1 << 40], np.int64), N)
    f64 = rng.choice(np.array([-2.5, 1.0, np.nan, 3.5]), N)
    out = []
    for vals, rt, pt in ((i32, RT.INT32, T.INT32), (f32, RT.FLOAT32,
                                                    T.FLOAT32),
                         (i64, RT.INT64, T.INT64), (f64, RT.FLOAT64,
                                                    T.FLOAT64)):
        valid = rng.random(N) > 0.15
        out.append((RVector.from_numpy(vals, rt, valid, CAP),
                    ColumnVector.from_numpy(vals, pt, valid, CAP,
                                            device="cpu")))
    return out


def _row_mask(seed):
    mask = np.random.default_rng(seed).random(CAP) > 0.2
    mask[N:] = False
    return jnp.asarray(mask), torch.from_numpy(mask)


@pytest.mark.parametrize("keys", [[(0, True, True), (1, False, False)],
                                  [(2, True, False), (3, False, True)],
                                  [(1, True, True), (0, True, True),
                                   (2, False, True)]])
def test_sort_with_bounds_matches_reference(keys):
    cols = _columns(21)
    rmask, pmask = _row_mask(22)
    r_perm, r_valid, r_bounds, _ = RS.sort_with_bounds(
        [(cols[i][0], a, nf) for i, a, nf in keys], rmask)
    p_perm, p_valid, p_bounds = S.sort_with_bounds(
        [(cols[i][1], a, nf) for i, a, nf in keys], pmask)
    np.testing.assert_array_equal(p_perm.numpy(), np.asarray(r_perm))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(p_bounds.numpy(), np.asarray(r_bounds))
    r_seg = RS.segment_boundaries([cols[i][0] for i, _, _ in keys],
                                  r_perm, rmask)
    p_seg = S.segment_boundaries([cols[i][1] for i, _, _ in keys],
                                 p_perm, pmask)
    np.testing.assert_array_equal(p_seg.numpy(), np.asarray(r_seg))
    r_ms = RS.multi_key_argsort([(cols[i][0], a, nf) for i, a, nf in keys],
                                rmask)
    p_ms = S.multi_key_argsort([(cols[i][1], a, nf) for i, a, nf in keys],
                               pmask)
    np.testing.assert_array_equal(p_ms.numpy(), np.asarray(r_ms))


@pytest.mark.parametrize("size", [7, 300, 1024])
def test_masked_positions_matches_reference(size):
    rmask, pmask = _row_mask(23)
    want = np.asarray(RS.masked_positions(rmask, size, fill_value=CAP - 1))
    got = S.masked_positions(pmask, size, fill_value=CAP - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_key_set_routing_matches_reference():
    for specs in ([(T.INT32, False)] * 2, [(T.INT64, False)] * 4,
                  [(T.FLOAT64, False), (T.INT32, False)] * 3):
        ref_specs = [(RS._WidthOnly(getattr(RT, dt.id.name)), True, True)
                     for dt, _ in specs]
        assert S.estimate_packed_words(specs) == \
            RS.estimate_packed_words(ref_specs)
