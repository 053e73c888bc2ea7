"""Sortable key encoding, multi-key argsort, device-side compaction and
the murmur3 grouping sort (port of spark_rapids_tpu/ops/sort_encode.py).

Each key column encodes into non-negative int64 keys whose integer order
is SQL order, each with its bit width, so several keys pack into one sort
word:
  - a null-rank bit ahead of the value (nulls first or last);
  - ints and dates: biased by the sign bit; an int64 without an int32
    shadow sorts as its own signed word;
  - floats: an is-NaN bit (Spark: NaN is largest) ahead of the value;
    float32 values use the IEEE total-order trick with -0.0 folded into
    0.0, float64 values sort as their own float word.
Value bits are zeroed under null and NaN rows, so word equality is SQL
group equality and segment boundaries come straight off the sorted words.
Invalid rows (padding, filtered) sort last via the most significant key.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector

#: packed sort words stay non-negative int64
WORD_BITS = 62
_U32 = (1 << 32) - 1


def _enc32(x: torch.Tensor, ascending: bool):
    """int32 values -> [0, 2^32) int64 key in value order."""
    enc = x.to(torch.int64) + (1 << 31)
    if not ascending:
        enc = _U32 - enc
    return (enc, 32)


def encode_key_bits(col: ColumnVector, ascending: bool = True,
                    nulls_first: bool = True) -> list:
    """Sort keys of one column, most significant first, as (tensor, bits);
    bits None marks an unpackable key (float64 values, int64 values
    without a shadow) that is a sort word of its own."""
    valid = col.validity
    keys: list = [(torch.where(valid, 1 if nulls_first else 0,
                               0 if nulls_first else 1).to(torch.int64), 1)]
    dt = col.dtype
    if dt.is_string:
        pos = torch.arange(col.char_cap, device=valid.device)[None, :]
        b = torch.where(valid[:, None] & (pos < col.lengths[:, None]),
                        col.data.to(torch.int64) + 1, 0)
        if not ascending:
            b = 256 - b
        keys.extend((b[:, j], 9) for j in range(col.char_cap))
    elif dt.id == T.TypeId.FLOAT32:
        nan = torch.isnan(col.data) & valid
        keys.append(((nan if ascending else ~nan).to(torch.int64), 1))
        val = torch.where(valid & ~nan, col.data, 0.0)
        val = torch.where(val == 0.0, 0.0, val)  # -0.0 groups with 0.0
        bits = val.view(torch.int32).to(torch.int64) & _U32
        enc = torch.where(bits >> 31 == 1, _U32 - bits, bits | (1 << 31))
        if not ascending:
            enc = _U32 - enc
        keys.append((enc, 32))
    elif dt.id == T.TypeId.FLOAT64:
        nan = torch.isnan(col.data) & valid
        keys.append(((nan if ascending else ~nan).to(torch.int64), 1))
        val = torch.where(valid & ~nan, col.data, 0.0)
        keys.append((val if ascending else -val, None))
    elif dt.id == T.TypeId.BOOL:
        enc = (valid & col.data).to(torch.int64)
        keys.append((enc if ascending else 1 - enc, 1))
    elif dt.id in (T.TypeId.INT32, T.TypeId.DATE32):
        keys.append(_enc32(torch.where(valid, col.data, 0), ascending))
    elif col.narrow is not None:
        # int64 whose values fit int32: a 32-bit key packs with others
        keys.append(_enc32(torch.where(valid, col.narrow, 0), ascending))
    else:  # int64: signed order; ~x reverses it without overflow
        x = torch.where(valid, col.data, 0)
        keys.append((x if ascending else ~x, None))
    return keys


def _pack_words(keys_msf: list) -> list:
    """Greedily pack (tensor, bits) keys MSF->LSF into words of at most
    WORD_BITS; an unpackable key is a word of its own."""
    words: list = []
    acc, used = None, 0
    for arr, bits in keys_msf:
        if bits is None:
            if acc is not None:
                words.append(acc)
                acc, used = None, 0
            words.append(arr)
        elif acc is not None and used + bits <= WORD_BITS:
            acc = (acc << bits) | arr
            used += bits
        else:
            if acc is not None:
                words.append(acc)
            acc, used = arr, bits
    if acc is not None:
        words.append(acc)
    return words


def _sort_words(words: list) -> torch.Tensor:
    """Stable argsort by words, most significant first (LSD chain of
    stable sorts)."""
    cap = words[0].shape[0]
    perm = torch.arange(cap, device=words[0].device)
    for w in reversed(words):
        _, idx = torch.sort(w[perm], stable=True)
        perm = perm[idx]
    return perm


def packed_lexsort(keys_msf: list) -> torch.Tensor:
    """Stable multi-key argsort over (tensor, bits) keys, most significant
    first: the keys pack into sort words, and rows whose keys are all
    equal keep their input order."""
    return _sort_words(_pack_words(keys_msf))


def _neq_prev(sorted_words) -> torch.Tensor:
    """True where any sorted word differs from its predecessor."""
    acc = torch.zeros_like(sorted_words[0], dtype=torch.bool)
    for s in sorted_words:
        acc = acc | (s != torch.roll(s, 1))
    return acc


def sort_with_bounds(key_cols: list, row_mask: torch.Tensor):
    """Argsort by (column, ascending, nulls_first) keys and derive the
    segment boundaries from the sorted words.  Returns (perm,
    sorted_valid, bounds); invalid rows sort last and never start a
    segment."""
    cap = row_mask.shape[0]
    keys = [((~row_mask).to(torch.int64), 1)]
    for c, asc, nf in key_cols:
        keys.extend(encode_key_bits(c, asc, nf))
    words = _pack_words(keys)
    perm = _sort_words(words)
    iota = torch.arange(cap, device=row_mask.device)
    sorted_valid = iota < row_mask.sum()
    bounds = sorted_valid & (_neq_prev([w[perm] for w in words])
                             | (iota == 0))
    return perm, sorted_valid, bounds


def multi_key_argsort(key_cols: list, row_mask: torch.Tensor
                      ) -> torch.Tensor:
    """Stable argsort by multiple (column, ascending, nulls_first) keys;
    invalid rows sort last."""
    keys = [((~row_mask).to(torch.int64), 1)]
    for c, asc, nf in key_cols:
        keys.extend(encode_key_bits(c, asc, nf))
    return _sort_words(_pack_words(keys))


def masked_positions(mask: torch.Tensor, size: int,
                     fill_value: int) -> torch.Tensor:
    """First `size` indices where `mask` is set, ascending, then
    `fill_value` — computed on the device (torch.nonzero would wait for
    the host to learn the count)."""
    cap = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    target = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, target, torch.arange(cap, device=mask.device))
    return out[:size]


def segment_boundaries(key_cols: list, perm: torch.Tensor,
                       row_mask: torch.Tensor) -> torch.Tensor:
    """After sorting by perm, True where a new group starts (valid rows
    only).  Equal keys = equal (value, null-flag) pairs; two nulls are one
    group, and so are two NaNs."""
    cap = perm.shape[0]
    sorted_mask = row_mask[perm]
    diff = torch.zeros(cap, dtype=torch.bool, device=perm.device)
    for c in key_cols:
        v = c.validity[perm]
        v_prev = torch.roll(v, 1)
        d = c.data[perm]
        d_prev = torch.roll(d, 1, 0)
        if c.dtype.is_string:
            ln = c.lengths[perm]
            ln_prev = torch.roll(ln, 1)
            pos = torch.arange(c.char_cap, device=perm.device)[None, :]
            in_a = pos < ln[:, None]
            in_b = pos < ln_prev[:, None]
            byte_neq = ((d != d_prev) & in_a & in_b).any(dim=1)
            val_neq = byte_neq | (ln != ln_prev)
        else:
            val_neq = d != d_prev
        if c.dtype.is_floating:
            val_neq = val_neq & ~(torch.isnan(d) & torch.isnan(d_prev))
        diff = diff | (v != v_prev) | (v & v_prev & val_neq)
    first = torch.arange(cap, device=perm.device) == 0
    return sorted_mask & (diff | first)


# -- the murmur3 hash-grouping lane -----------------------------------------
#: past this many estimated packed sort words a GROUPING key set routes
#: through the 2-word murmur3 sort (see hash_sort_bounds)
HASH_GROUP_MIN_WORDS = 4


def _key_bit_widths(dtype: T.DataType, has_narrow: bool,
                    char_cap: int = 0) -> list:
    """Bit widths `encode_key_bits` emits for one key (None = an
    unpackable float64 value word).  Kept beside `encode_key_bits`: the
    two tables must agree for the routing estimate to match the
    encode."""
    out = [1]  # null rank
    if dtype.is_string:
        out += [9] * char_cap
    elif dtype.id == T.TypeId.FLOAT32:
        out += [1, 32]
    elif dtype.is_floating:
        out += [1, None]
    elif dtype.id == T.TypeId.BOOL:
        out += [1]
    elif dtype.id in (T.TypeId.INT32, T.TypeId.DATE32) or has_narrow:
        out += [32]
    else:
        out += [64]
    return out


def estimate_packed_words(key_specs) -> int:
    """Static count of the 64-bit sort words the reference's lexicographic
    encode needs for (dtype, has_narrow[, char_cap]) keys (its routing
    rule)."""
    widths = [1]  # invalid-rows lead flag
    for spec in key_specs:
        widths.extend(_key_bit_widths(*spec))
    words, used = 0, 0
    for bits in widths:
        if bits is None:
            words += (1 if used else 0) + 1
            used = 0
        elif used and used + bits <= 64:
            used += bits
        else:
            words += 1 if used else 0
            used = bits
    return words + (1 if used else 0)


def wide_key_set(bound_exprs, batch, schema,
                 threshold: int = HASH_GROUP_MIN_WORDS) -> bool:
    """True when the grouping keys would take more than `threshold`
    packed words.  `batch` None (a fused pre-stage: the batch holds the
    raw child columns) routes on dtypes alone; a computed string key is
    always wide."""
    specs = []
    for e in bound_exprs:
        ordinal = getattr(e, "ordinal", None)
        if ordinal is not None and batch is not None:
            c = batch.columns[ordinal]
            specs.append((c.dtype, c.narrow is not None,
                          c.char_cap if c.dtype.is_string else 0))
            continue
        dt = e.data_type(schema)
        if dt.is_string:
            return True
        specs.append((dt, False))
    return estimate_packed_words(specs) > threshold


def _grouping_hash(cols, seed: int) -> torch.Tensor:
    """Row hash of the hash-grouping lane, int64 in [0, 2^32).  Not
    Spark's Murmur3Hash: Spark chains a null as the unchanged seed, so
    (NULL, x) and (x, NULL) would collide on every seed; here a null
    mixes a per-column marker into the chain instead, so only genuine
    64-bit accidents collide."""
    from spark_rapids_tpu_torch.ops.murmur3 import hash_column, hash_int
    cap = cols[0].capacity
    h = torch.full((cap,), seed, dtype=torch.int64, device=cols[0].device)
    for i, c in enumerate(cols):
        hc = hash_column(c, h)
        mark = torch.full_like(h, (0x9E3779B9 * (i + 1)) & 0xFFFFFFFF)
        h = torch.where(c.validity, hc, hash_int(mark, h))
    return h


def hash_sort_bounds(key_cols: list, row_mask: torch.Tensor):
    """Equality-only grouping: sort rows by TWO murmur3 words instead of
    the full lexicographic encode, then read exact segment boundaries
    off the actual key values of adjacent sorted rows.  SQL-equal keys
    always hash equal, so a group can only fragment when two different
    key tuples collide on both 32-bit words; that is detected exactly (a
    key boundary with no hash change) and returned as a deferred flag
    the caller turns into a deopt check.  Returns (perm, sorted_valid,
    bounds, collision_flag)."""
    cols = [c for c, _asc, _nf in key_cols]
    perm, sorted_valid, bounds, _all, collision = \
        hash_prefix_sort_bounds(cols, [], row_mask)
    return perm, sorted_valid, bounds, collision


def hash_prefix_sort_bounds(part_cols: list, order_keys: list,
                            row_mask: torch.Tensor):
    """`sort_with_bounds` for window-style keys: the PARTITION prefix
    needs grouping only, so it sorts as two murmur3 words whatever its
    width, while the ORDER keys keep the exact lexicographic encode.
    Returns (perm, sorted_valid, prefix_bounds, all_bounds,
    collision_flag)."""
    cap = row_mask.shape[0]
    h1 = _grouping_hash(part_cols, 42)
    h2 = _grouping_hash(part_cols, 0x3C6EF372)
    w1 = ((~row_mask).to(torch.int64) << 32) | h1
    rest: list = []
    for col, asc, nf in order_keys:
        rest.extend(encode_key_bits(col, asc, nf))
    words = [w1, h2] + _pack_words(rest)
    perm = _sort_words(words)
    iota = torch.arange(cap, device=row_mask.device)
    sorted_valid = iota < row_mask.sum()
    first = iota == 0
    prefix_bounds = segment_boundaries(part_cols, perm, row_mask)
    swords = [w[perm] for w in words]
    hash_change = _neq_prev(swords[:2])
    collision = (prefix_bounds & ~hash_change & ~first).any()
    if len(words) > 2:
        all_bounds = sorted_valid & (prefix_bounds | _neq_prev(swords[2:])
                                     | first)
    else:
        all_bounds = prefix_bounds
    return perm, sorted_valid, prefix_bounds, all_bounds, collision
