"""String expressions (port of the TPC-H part of
spark_rapids_tpu/exprs/string_fns.py: Length, Substring, Contains,
StartsWith, EndsWith and Like).

Everything works on the uint8[capacity, char_cap] byte matrix of a
string column, whole batch at once.  Spark counts characters, not
bytes: a byte starts a UTF-8 character when (b & 0xC0) != 0x80.
Contains/StartsWith/EndsWith and LIKE need a literal pattern (the
reference's restriction); a null pattern gives null.  LIKE matches
character by character: input and pattern are packed to one integer per
UTF-8 character, then a DP over the pattern's positions steps across
the character slots, a few tensor ops per slot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (Expression, Literal,
                                               UnaryExpression)


def _positions(data: torch.Tensor) -> torch.Tensor:
    return torch.arange(data.shape[1], device=data.device)[None, :]


def _char_starts(data, lengths):
    """bool[cap, cc]: the byte is the first byte of a UTF-8 character."""
    in_str = _positions(data) < lengths[:, None]
    return in_str & ((data & 0xC0) != 0x80)


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
