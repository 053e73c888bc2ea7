"""String expressions (port of spark_rapids_tpu/exprs/string_fns.py).

Everything works on the uint8[capacity, char_cap] byte matrix of a
string column, whole batch at once.  Spark counts characters, not
bytes: a byte starts a UTF-8 character when (b & 0xC0) != 0x80.
Contains/StartsWith/EndsWith and LIKE need a literal pattern (the
reference's restriction); a null pattern gives null.  LIKE matches
character by character: input and pattern are packed to one integer per
UTF-8 character, then a DP over the pattern's positions steps across
the character slots, a few tensor ops per slot.  Upper/Lower/InitCap
fold ASCII only, as the reference does.  The regex functions take only a
pattern free of regex metacharacters, which they rewrite to the literal
function (the reference's regexp-as-literal rule).  An expression that
makes new strings (concat, replace, pad) sizes its char capacity from
its inputs' capacities, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    _pad_chars,
                                                    bucket_char_cap)
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               Literal, UnaryExpression)


def _positions(data: torch.Tensor) -> torch.Tensor:
    return torch.arange(data.shape[1], device=data.device)[None, :]


def _char_starts(data, lengths):
    """bool[cap, cc]: the byte is the first byte of a UTF-8 character."""
    in_str = _positions(data) < lengths[:, None]
    return in_str & ((data & 0xC0) != 0x80)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 where none is)."""
    return mask.to(torch.int8).argmax(dim=1)


def last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along dim 1 (cc - 1 where none is)."""
    return mask.shape[1] - 1 - first_true(mask.flip(1))


def _char_count(data, lengths):
    return _char_starts(data, lengths).sum(dim=1).to(torch.int32)


def _pack_chars(data, lengths):
    """Compact the UTF-8 characters into int64[cap, cc]: character i's
    bytes big-endian from bit 31 down, in slot i (0 past the last
    character), and the character counts.  Char-wise algorithms (LIKE)
    then compare whole characters at once."""
    cap, cc = data.shape
    starts = _char_starts(data, lengths)
    pos = _positions(data)
    in_str = pos < lengths[:, None]
    char_idx = torch.cumsum(starts.to(torch.int32), dim=1) - 1
    # byte offset within its character: pos - (last start <= pos)
    start_pos = torch.cummax(torch.where(starts, pos, -1), dim=1).values
    shift = torch.clamp(pos - start_pos, 0, 3)
    contrib = data.to(torch.int64) << ((3 - shift) * 8)
    tgt = torch.where(in_str & (char_idx >= 0), char_idx.to(torch.int64),
                      cc)
    packed = torch.zeros((cap, cc + 1), dtype=torch.int64,
                         device=data.device)
    packed.scatter_add_(1, tgt, contrib * in_str)
    return packed[:, :cc], starts.sum(dim=1).to(torch.int32)


def _pack_literal_chars(text: str) -> list[int]:
    """Pack each character of a host-side literal the same way."""
    out = []
    for ch in text:
        v = 0
        for j, byte in enumerate(ch.encode("utf-8")):
            v |= byte << ((3 - j) * 8)
        out.append(v)
    return out


@dataclasses.dataclass(eq=False, repr=False)
class Length(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.INT32

    def do_columnar(self, c, ctx):
        return ColumnVector(T.INT32, _char_count(c.data, c.lengths),
                            c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class _CaseFold(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.STRING

    def do_columnar(self, c, ctx):
        return ColumnVector(T.STRING, self.fold(c.data), c.validity,
                            lengths=c.lengths)


class Upper(_CaseFold):
    def fold(self, data):
        is_lower = (data >= ord("a")) & (data <= ord("z"))
        return torch.where(is_lower, data - 32, data).to(torch.uint8)


class Lower(_CaseFold):
    def fold(self, data):
        is_upper = (data >= ord("A")) & (data <= ord("Z"))
        return torch.where(is_upper, data + 32, data).to(torch.uint8)


@dataclasses.dataclass(eq=False, repr=False)
class InitCap(UnaryExpression):
    """The first letter of each space-separated word upper case, the
    rest lower case (ASCII)."""
    child: Expression

    def data_type(self, schema):
        return T.STRING

    def do_columnar(self, c, ctx):
        data = c.data
        prev_space = torch.cat(
            [torch.ones((data.shape[0], 1), dtype=torch.bool,
                        device=data.device),
             data[:, :-1] == ord(" ")], dim=1)
        is_lower = (data >= ord("a")) & (data <= ord("z"))
        is_upper = (data >= ord("A")) & (data <= ord("Z"))
        up = torch.where(prev_space & is_lower, data - 32, data)
        out = torch.where(~prev_space & is_upper, up + 32, up)
        return ColumnVector(T.STRING, out.to(torch.uint8), c.validity,
                            lengths=c.lengths)


def _compact_bytes(data, selected):
    """Keep the selected bytes of each row, shifted left; returns (bytes,
    new lengths)."""
    cc = data.shape[1]
    pos = _positions(data)
    key = torch.where(selected, pos, cc + pos)
    perm = torch.argsort(key, dim=1)
    out = torch.gather(data, 1, perm)
    new_len = selected.sum(dim=1).to(torch.int32)
    out = torch.where(pos < new_len[:, None], out, 0).to(torch.uint8)
    return out, new_len


@dataclasses.dataclass(eq=False)
class Substring(Expression):
    """substring(str, pos, len): 1-based character position; a negative
    pos counts from the end (Spark)."""
    child: Expression
    pos: Expression
    length: Optional[Expression] = None

    def data_type(self, schema):
        return T.STRING

    def children(self):
        kids = [self.child, self.pos]
        if self.length is not None:
            kids.append(self.length)
        return tuple(kids)

    def with_children(self, kids):
        return Substring(kids[0], kids[1],
                         kids[2] if len(kids) > 2 else None)

    def eval(self, ctx):
        c = self.child.eval(ctx)
        p = self.pos.eval(ctx)
        data, lengths = c.data, c.lengths
        nchars = _char_count(data, lengths)
        starts = _char_starts(data, lengths)
        char_idx = torch.cumsum(starts.to(torch.int32), dim=1) - 1
        pos0 = p.data.to(torch.int32)
        # pos 0 reads as 1; a negative pos counts from the end and may
        # land before the start, where no character is selected
        # (Spark's substring('h', -3, 2) = '')
        start = torch.where(pos0 > 0, pos0 - 1,
                            torch.where(pos0 < 0, nchars + pos0, 0))
        if self.length is not None:
            ln = self.length.eval(ctx)
            want = torch.clamp(ln.data.to(torch.int32), min=0)
            validity = c.validity & p.validity & ln.validity
        else:
            want = torch.full((ctx.capacity,), 2 ** 30, dtype=torch.int32,
                              device=ctx.device)
            validity = c.validity & p.validity
        in_str = _positions(data) < lengths[:, None]
        sel = (in_str & (char_idx >= start[:, None])
               & (char_idx < (start + want)[:, None]))
        out, new_len = _compact_bytes(data, sel)
        return ColumnVector(T.STRING, out, validity, lengths=new_len)


def _find_pattern(data, lengths, pat: bytes):
    """bool[cap, cc]: the literal pattern matches from this byte on."""
    pos = _positions(data)
    if len(pat) == 0:
        return pos <= lengths[:, None]
    hit = torch.ones(data.shape, dtype=torch.bool, device=data.device)
    for j, ch in enumerate(pat):
        hit = hit & (torch.roll(data, -j, dims=1) == ch)
    return hit & (pos + len(pat) <= lengths[:, None])


@dataclasses.dataclass(eq=False)
class _LiteralPatternPredicate(Expression):
    """Base of StartsWith/EndsWith/Contains with a literal pattern."""
    child: Expression
    pattern: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.child, self.pattern)

    def with_children(self, kids):
        return type(self)(kids[0], kids[1])

    def _pat_bytes(self) -> bytes:
        if not isinstance(self.pattern, Literal):
            raise TypeError(f"{type(self).__name__} requires a literal "
                            f"pattern")
        return str(self.pattern.value).encode("utf-8")

    def eval(self, ctx):
        if isinstance(self.pattern, Literal) and self.pattern.value is None:
            return Literal(None, T.BOOL).eval(ctx)
        c = self.child.eval(ctx)
        return ColumnVector(T.BOOL, self.test(c, self._pat_bytes()),
                            c.validity)


class Contains(_LiteralPatternPredicate):
    def test(self, c, pat):
        return _find_pattern(c.data, c.lengths, pat).any(dim=1)


class StartsWith(_LiteralPatternPredicate):
    def test(self, c, pat):
        return _find_pattern(c.data, c.lengths, pat)[:, 0]


class EndsWith(_LiteralPatternPredicate):
    def test(self, c, pat):
        hits = _find_pattern(c.data, c.lengths, pat)
        at = torch.clamp(c.lengths - len(pat), 0, c.char_cap - 1)
        ok = torch.gather(hits, 1, at[:, None].to(torch.int64))[:, 0]
        return ok & (c.lengths >= len(pat))


@dataclasses.dataclass(eq=False)
class Like(Expression):
    """SQL LIKE with % and _ and the escape \\, character-wise (see the
    module docstring).  A null pattern gives null."""
    child: Expression
    pattern: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.child, self.pattern)

    def with_children(self, kids):
        return Like(kids[0], kids[1])

    def _parse_pattern(self) -> list:
        """[(kind, packed char)], kind "any" (%), "one" (_) or "ch"."""
        if not isinstance(self.pattern, Literal):
            raise TypeError("LIKE requires a literal pattern")
        chars = list(str(self.pattern.value))
        toks, i = [], 0
        while i < len(chars):
            ch = chars[i]
            if ch == "\\" and i + 1 < len(chars):
                toks.append(("ch", _pack_literal_chars(chars[i + 1])[0]))
                i += 2
                continue
            if ch == "%":
                toks.append(("any", 0))
            elif ch == "_":
                toks.append(("one", 0))
            else:
                toks.append(("ch", _pack_literal_chars(ch)[0]))
            i += 1
        return toks

    def eval(self, ctx):
        c = self.child.eval(ctx)
        if isinstance(self.pattern, Literal) and self.pattern.value is None:
            return Literal(None, T.BOOL).eval(ctx)
        toks = self._parse_pattern()
        packed, nchars = _pack_chars(c.data, c.lengths)
        cap, cc = packed.shape
        # dp[j]: the first j pattern tokens match the characters so far
        dp = [torch.ones(cap, dtype=torch.bool, device=ctx.device)]
        leading = True
        for kind, _ in toks:  # leading %s match the empty prefix
            leading = leading and kind == "any"
            dp.append(dp[0] if leading else torch.zeros_like(dp[0]))
        for i in range(cc):
            ch_val = packed[:, i]
            in_str = i < nchars
            ndp = [torch.zeros_like(dp[0])]
            for j, (kind, pch) in enumerate(toks):
                if kind == "any":
                    ndp.append(ndp[j] | dp[j + 1] | dp[j])
                elif kind == "one":
                    ndp.append(dp[j])
                else:
                    ndp.append(dp[j] & (ch_val == pch))
            dp = [torch.where(in_str, n, o) for n, o in zip(ndp, dp)]
        return ColumnVector(T.BOOL, dp[-1], c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class _Trim(UnaryExpression):
    """Trims spaces (0x20) only, as Spark's trim does."""
    child: Expression

    def data_type(self, schema):
        return T.STRING

    def do_columnar(self, c, ctx):
        data, lengths = c.data, c.lengths
        pos = _positions(data)
        in_str = pos < lengths[:, None]
        nonspace = in_str & (data != ord(" "))
        any_ns = nonspace.any(dim=1)
        # an all-space string selects nothing (first past the end)
        first = torch.where(any_ns, first_true(nonspace), lengths)
        last = torch.where(any_ns, last_true(nonspace), -1)
        lo, hi = self.window(first, last, lengths)
        sel = in_str & (pos >= lo[:, None]) & (pos <= hi[:, None])
        out, new_len = _compact_bytes(data, sel)
        return ColumnVector(T.STRING, out, c.validity, lengths=new_len)


class StringTrim(_Trim):
    def window(self, first, last, lengths):
        return first, last


class StringTrimLeft(_Trim):
    def window(self, first, last, lengths):
        return first, lengths - 1


class StringTrimRight(_Trim):
    def window(self, first, last, lengths):
        return torch.zeros_like(first), last


@dataclasses.dataclass(eq=False)
class ConcatStrings(Expression):
    """concat(s1, s2, ...): null if any input is null (Spark's concat)."""
    exprs: tuple

    def data_type(self, schema):
        return T.STRING

    def children(self):
        return tuple(self.exprs)

    def with_children(self, kids):
        return ConcatStrings(tuple(kids))

    def eval(self, ctx):
        cols = [e.eval(ctx) for e in self.exprs]
        out = cols[0]
        for c in cols[1:]:
            out = _concat2(out, c)
        return out


def _concat2(a: ColumnVector, b: ColumnVector) -> ColumnVector:
    cc = bucket_char_cap(a.char_cap + b.char_cap)
    a2, b2 = _pad_chars(a, cc), _pad_chars(b, cc)
    pos = _positions(a2.data)
    la = a.lengths[:, None]
    from_b = torch.clamp(pos - la, 0, cc - 1).to(torch.int64)
    bvals = torch.gather(b2.data, 1, from_b)
    out = torch.where(pos < la, a2.data, bvals)
    new_len = (a.lengths + b.lengths).to(torch.int32)
    out = torch.where(pos < new_len[:, None], out, 0).to(torch.uint8)
    return ColumnVector(T.STRING, out, a.validity & b.validity,
                        lengths=new_len)


@dataclasses.dataclass(eq=False)
class StringLocate(Expression):
    """locate(substr, str, start=1): the 1-based character position of
    the first occurrence at or after start; 0 if there is none.
    `substr` must be a literal."""
    substr: Expression
    child: Expression
    start: Optional[Expression] = None

    def data_type(self, schema):
        return T.INT32

    def children(self):
        kids = [self.substr, self.child]
        if self.start is not None:
            kids.append(self.start)
        return tuple(kids)

    def with_children(self, kids):
        return StringLocate(kids[0], kids[1],
                            kids[2] if len(kids) > 2 else None)

    def eval(self, ctx):
        if not isinstance(self.substr, Literal):
            raise TypeError("locate requires a literal substring")
        if self.substr.value is None:
            return Literal(None, T.INT32).eval(ctx)
        c = self.child.eval(ctx)
        pat = str(self.substr.value).encode("utf-8")
        hits = _find_pattern(c.data, c.lengths, pat)
        starts = _char_starts(c.data, c.lengths)
        char_idx = torch.cumsum(starts.to(torch.int32), dim=1) - 1
        if self.start is not None:
            s = self.start.eval(ctx)
            min_char = s.data.to(torch.int32) - 1
            validity = c.validity & s.validity
        else:
            min_char = torch.zeros(ctx.capacity, dtype=torch.int32,
                                   device=ctx.device)
            validity = c.validity
        ok = hits & (char_idx >= min_char[:, None])
        found = ok.any(dim=1)
        at = torch.gather(char_idx, 1, first_true(ok)[:, None])[:, 0]
        res = torch.where(found, at + 1, 0)
        # Spark: a start below 1 gives 0 whatever the string
        res = torch.where(min_char < 0, 0, res)
        return ColumnVector(T.INT32, res.to(torch.int32), validity)


@dataclasses.dataclass(eq=False)
class StringReplace(Expression):
    """replace(str, search, replacement), both literals: greedy,
    non-overlapping, left to right, as Java's String.replace."""
    child: Expression
    search: Expression
    replacement: Expression

    def data_type(self, schema):
        return T.STRING

    def children(self):
        return (self.child, self.search, self.replacement)

    def with_children(self, kids):
        return StringReplace(*kids)

    def eval(self, ctx):
        if not (isinstance(self.search, Literal)
                and isinstance(self.replacement, Literal)):
            raise TypeError("replace requires literal search/replacement")
        if self.search.value is None or self.replacement.value is None:
            return Literal(None, T.STRING).eval(ctx)
        c = self.child.eval(ctx)
        s = str(self.search.value).encode("utf-8")
        r = str(self.replacement.value).encode("utf-8")
        if len(s) == 0:
            return c
        data, lengths = c.data, c.lengths
        cap, cc = data.shape
        hits = _find_pattern(data, lengths, s)
        if len(s) == 1:
            accepted = hits  # one-byte matches cannot overlap
        else:
            # greedy: a hit counts when it starts at or past the last
            # accepted match's end
            last_end = torch.zeros(cap, dtype=torch.int32,
                                   device=data.device)
            cols = []
            for i in range(cc):
                h = hits[:, i] & (i >= last_end)
                last_end = torch.where(h, i + len(s), last_end)
                cols.append(h)
            accepted = torch.stack(cols, dim=1)
        start_flags = accepted.to(torch.int32)
        n_matches = start_flags.sum(dim=1).to(torch.int32)
        end_flags = torch.roll(accepted, len(s), dims=1)
        end_flags[:, :len(s)] = False
        inside = (torch.cumsum(start_flags, dim=1)
                  - torch.cumsum(end_flags.to(torch.int32), dim=1)) > 0
        new_len = (lengths + n_matches * (len(r) - len(s))).to(torch.int32)
        out_cc = bucket_char_cap(int(
            cc if len(r) <= len(s) else cc * max(1, -(-len(r) // len(s)))))
        pos = _positions(data)
        copy = (pos < lengths[:, None]) & ~inside
        copy_i = copy.to(torch.int32)
        # a copied byte lands after the bytes copied before it and the
        # replacements of the matches before it
        copied_before = torch.cumsum(copy_i, dim=1) - copy_i
        matches_before = torch.cumsum(start_flags, dim=1) - start_flags
        base = (copied_before + matches_before * len(r)).to(torch.int64)
        out = torch.zeros((cap, out_cc + 1), dtype=torch.uint8,
                          device=data.device)
        out.scatter_(1, torch.where(copy, base, out_cc), data)
        for j, ch in enumerate(r):
            tgt = torch.where(accepted, base + j, out_cc)
            out.scatter_(1, tgt, torch.full_like(data, ch))
        out = out[:, :out_cc]
        out = torch.where(_positions(out) < new_len[:, None], out, 0).to(
            torch.uint8)
        return ColumnVector(T.STRING, out, c.validity, lengths=new_len)


@dataclasses.dataclass(eq=False)
class _Pad(Expression):
    """lpad/rpad counted in UTF-8 characters, never splitting one: the
    string is cut to the target length, and the pad prefix of every
    possible fill count comes from a host table gathered per row.  The
    length and the pad string must be literals; a null one gives
    null."""
    child: Expression
    target_len: Expression
    pad: Expression

    def data_type(self, schema):
        return T.STRING

    def children(self):
        return (self.child, self.target_len, self.pad)

    def with_children(self, kids):
        return type(self)(*kids)

    def eval(self, ctx):
        if not (isinstance(self.target_len, Literal)
                and isinstance(self.pad, Literal)):
            raise TypeError("pad requires literal length and pad string")
        if self.target_len.value is None or self.pad.value is None:
            return Literal(None, T.STRING).eval(ctx)
        c = self.child.eval(ctx)
        tlen = max(int(self.target_len.value), 0)
        pad_str = str(self.pad.value)
        starts = _char_starts(c.data, c.lengths)
        char_idx = torch.cumsum(starts.to(torch.int32), dim=1) - 1
        sel = (_positions(c.data) < c.lengths[:, None]) & (char_idx < tlen)
        tb, tl = _compact_bytes(c.data, sel)
        trunc = ColumnVector(T.STRING, tb, c.validity, lengths=tl)
        if not pad_str:
            return trunc
        nchars = _char_count(c.data, c.lengths)
        cycle = (pad_str * (tlen // len(pad_str) + 1))[:tlen]
        prefixes = [cycle[:n].encode("utf-8") for n in range(tlen + 1)]
        width = max(max(len(p) for p in prefixes), 1)
        tbl = np.zeros((tlen + 1, width), np.uint8)
        tlens = np.zeros(tlen + 1, np.int32)
        for n, p in enumerate(prefixes):
            tbl[n, :len(p)] = np.frombuffer(p, np.uint8)
            tlens[n] = len(p)
        npad = torch.clamp(tlen - nchars, 0, tlen).to(torch.int64)
        dev = c.device
        prefix = ColumnVector(
            T.STRING, torch.from_numpy(tbl).to(dev)[npad], c.validity,
            lengths=torch.from_numpy(tlens).to(dev)[npad])
        return self.compose(prefix, trunc)


class LPad(_Pad):
    def compose(self, prefix, trunc):
        return _concat2(prefix, trunc)


class RPad(_Pad):
    def compose(self, prefix, trunc):
        return _concat2(trunc, prefix)


_REGEX_META = r".^$*+?()[]{}|\\"


def RLike(child: Expression, pattern: Expression) -> Expression:
    """Regex match; only a literal free of metacharacters, which becomes
    Contains."""
    if isinstance(pattern, Literal):
        if pattern.value is None:
            return Literal(None, T.BOOL)
        if not any(ch in str(pattern.value) for ch in _REGEX_META):
            return Contains(child, pattern)
    raise TypeError("RLike supports only literal patterns without regex "
                    "metacharacters")


def RegExpReplace(child: Expression, pattern: Expression,
                  replacement: Expression) -> Expression:
    """Regex replace; only a literal free of metacharacters, which
    becomes StringReplace."""
    if isinstance(pattern, Literal):
        if pattern.value is None:
            return Literal(None, T.STRING)
        if not any(ch in str(pattern.value) for ch in _REGEX_META):
            return StringReplace(child, pattern, replacement)
    raise TypeError("RegExpReplace supports only literal patterns without "
                    "regex metacharacters")


def _split_part(c: ColumnVector, delim: bytes, n, limit: int
                ) -> ColumnVector:
    """Part `n` (0-based; an int or a per-row tensor) of each string
    split on a literal delimiter, with Java's split: limit -1 keeps
    trailing empty parts, limit > 0 leaves the unsplit rest in the last
    part.  No list column is made: the consumer (GetArrayItem) asks for
    one part and gets a string column."""
    cap, cc = c.data.shape
    chars, lens = c.data, c.lengths
    L = len(delim)
    pos = _positions(chars)
    padded = torch.nn.functional.pad(chars, (0, L))
    raw = torch.ones((cap, cc), dtype=torch.bool, device=chars.device)
    for t, byte in enumerate(delim):
        raw = raw & (padded[:, t:t + cc] == byte)
    raw = raw & ((pos + L) <= lens[:, None])
    if L == 1:
        vm = raw  # one-byte delimiters cannot overlap
    else:
        next_free = torch.zeros(cap, dtype=torch.int64, device=chars.device)
        cols = []
        for j in range(cc):
            m = raw[:, j] & (j >= next_free)
            cols.append(m)
            next_free = torch.where(m, j + L, next_free)
        vm = torch.stack(cols, dim=1)
    mcum = torch.cumsum(vm.to(torch.int32), dim=1)
    if limit > 0:
        vm = vm & (mcum <= limit - 1)
        mcum = torch.cumsum(vm.to(torch.int32), dim=1)
    nparts = vm.sum(dim=1).to(torch.int32) + 1
    n = torch.as_tensor(n, dtype=torch.int32, device=chars.device)
    if n.dim() == 0:
        n = n.expand(cap)

    def match_pos(k):
        """Position of the k-th (1-based, per row) match."""
        mask = vm & (mcum == k[:, None])
        found = mask.any(dim=1)
        return torch.where(found, first_true(mask), lens), found

    pk, _ = match_pos(n)
    start = torch.where(n == 0, 0, pk + L)
    pk1, found1 = match_pos(n + 1)
    end = torch.where(found1, pk1, lens)
    exists = (n >= 0) & (n < nparts)
    out_len = torch.clamp(end - start, 0, cc).to(torch.int32)
    idx = torch.clamp(start[:, None] + pos, 0, cc - 1).to(torch.int64)
    gathered = torch.gather(chars, 1, idx)
    out = torch.where(pos < out_len[:, None], gathered, 0).to(torch.uint8)
    return ColumnVector(T.STRING, out, c.validity & exists,
                        lengths=torch.where(exists, out_len, 0))


@dataclasses.dataclass(eq=False)
class StringSplit(Expression):
    """split(str, pattern[, limit]) with a literal pattern free of regex
    metacharacters.  The type matrix has no array column, so a split is
    evaluated only under GetArrayItem (`split(s, d)[i]`, one fused
    split-and-index); the planner leaves a bare one on the CPU."""
    child: Expression
    pattern: Expression
    limit: Optional[Expression] = None

    def data_type(self, schema):
        return T.STRING  # the element type; the array is never made

    def children(self):
        return ((self.child, self.pattern, self.limit)
                if self.limit is not None else (self.child, self.pattern))

    def with_children(self, kids):
        return StringSplit(kids[0], kids[1],
                           kids[2] if len(kids) > 2 else None)

    def literal_pattern(self) -> Optional[str]:
        if not isinstance(self.pattern, Literal) or \
                self.pattern.value is None:
            return None
        p = str(self.pattern.value)
        if not p or any(ch in p for ch in _REGEX_META):
            return None
        return p

    def literal_limit(self) -> Optional[int]:
        if self.limit is None:
            return -1
        if isinstance(self.limit, Literal) and self.limit.value is not None:
            return int(self.limit.value)
        return None

    def eval(self, ctx: EvalContext):
        raise TypeError(
            "StringSplit must be consumed by GetArrayItem (split(s,d)[i]): "
            "the type matrix has no array columns")


@dataclasses.dataclass(eq=False)
class SubstringIndex(Expression):
    """substring_index(str, delim, count): count > 0 keeps what precedes
    the count-th delimiter, count < 0 what follows the count-th from the
    end.  delim and count must be literals."""
    child: Expression
    delim: Expression
    count: Expression

    def data_type(self, schema):
        return T.STRING

    def children(self):
        return (self.child, self.delim, self.count)

    def with_children(self, kids):
        return SubstringIndex(*kids)

    def literal_args(self):
        d = self.delim.value if isinstance(self.delim, Literal) else None
        n = self.count.value if isinstance(self.count, Literal) else None
        return d, n

    def eval(self, ctx):
        d, n = self.literal_args()
        if d is None or n is None:
            raise NotImplementedError(
                "substring_index needs a literal delimiter and count")
        c = self.child.eval(ctx)
        data, lengths = c.data, c.lengths
        cc = data.shape[1]
        dbytes = str(d).encode("utf-8")
        L = len(dbytes)
        n = int(n)
        if L == 0 or n == 0:
            # Spark: an empty delimiter or a count of 0 gives ""
            return ColumnVector(T.STRING, torch.zeros_like(data),
                                c.validity,
                                lengths=torch.zeros_like(lengths))
        pos = _positions(data)
        padded = torch.nn.functional.pad(data, (0, L))
        match = (pos + L) <= lengths[:, None]
        for k, b in enumerate(dbytes):
            match = match & (padded[:, k:k + cc] == b)
        occ = torch.cumsum(match.to(torch.int32), dim=1)
        total = occ[:, -1]
        if n > 0:
            cut = torch.where(total >= n, first_true(occ >= n), cc + L + 1)
            sel = pos < cut[:, None]
        else:
            k1 = total + n + 1  # 1-based index of the anchor delimiter
            cut = first_true(occ >= k1[:, None])
            start = torch.where(k1 >= 1, cut + L, 0)
            sel = pos >= start[:, None]
        out, new_len = _compact_bytes(data, sel & (pos < lengths[:, None]))
        return ColumnVector(T.STRING, out, c.validity, lengths=new_len)
