"""Sortable key encoding, multi-key argsort and device-side compaction
(port of spark_rapids_tpu/ops/sort_encode.py, numeric keys only).

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
    if dt.id == T.TypeId.FLOAT32:
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
        d_prev = torch.roll(d, 1)
        val_neq = d != d_prev
        if c.dtype.is_floating:
            val_neq = val_neq & ~(torch.isnan(d) & torch.isnan(d_prev))
        diff = diff | (v != v_prev) | (v & v_prev & val_neq)
    first = torch.arange(cap, device=perm.device) == 0
    return sorted_mask & (diff | first)


# -- hash-grouping lane routing (the lane itself is not ported) -------------
#: past this many estimated packed sort words the reference routes a
#: grouping key set through its murmur3 hash lane
HASH_GROUP_MIN_WORDS = 4


def _key_bit_widths(dtype: T.DataType, has_narrow: bool) -> list:
    out = [1]  # null rank
    if dtype.id == T.TypeId.FLOAT32:
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
    encode needs for (dtype, has_narrow) keys (its routing rule)."""
    widths = [1]  # invalid-rows lead flag
    for dt, has_narrow in key_specs:
        widths.extend(_key_bit_widths(dt, has_narrow))
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
    packed words — where the reference switches to its hash lane."""
    specs = []
    for e in bound_exprs:
        ordinal = getattr(e, "ordinal", None)
        if ordinal is not None and batch is not None:
            c = batch.columns[ordinal]
            specs.append((c.dtype, c.narrow is not None))
        else:
            specs.append((e.data_type(schema), False))
    return estimate_packed_words(specs) > threshold
