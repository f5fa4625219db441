"""A YAML reader and writer on the standard library, in place of PyYAML
(not on the card's machine).

:func:`load` reads the subset of YAML that the service configurations and
the Flow files use, and gives what PyYAML's ``safe_load`` (YAML 1.1)
gives for it:

* block mappings and sequences (a sequence may sit at its key's
  indentation), sequences of mappings, ``- - x`` nesting;
* flow sequences and mappings, over several lines too;
* plain, single-quoted and double-quoted scalars, folded over lines as
  YAML folds them, and comments;
* ``|`` and ``>`` block scalars with their chomping and indentation
  indicators;
* plain scalars resolved as YAML 1.1 resolves them: ints (decimal,
  ``0x``, ``0b``, octal ``0``-prefixed, ``1:30`` base 60, ``_``
  separators), floats (``.inf``, ``.nan``, base 60), ``true/false``,
  ``yes/no``, ``on/off`` in their three spellings, ``null``, ``~`` and the
  empty value; ``${{ ... }}`` stays text (JAML expands it later);
* ``---`` and ``...`` document markers (:func:`load_all` gives every
  document).

Anything else (anchors and aliases, tags, directives, ``?`` keys,
timestamps, merge keys, tabs in indentation, single-pair mappings inside
flow sequences) raises :class:`BadConfigSource` naming the line: the reader
never returns a value that PyYAML would not.

:func:`dump` writes block YAML that reads back equal through :func:`load`
and through PyYAML's ``safe_load``: strings that a plain scalar would not
keep are double-quoted with escapes, floats always carry a ``.`` or are
``.inf`` / ``.nan``.
"""

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from marie_tpu_torch.excepts import BadConfigSource

__all__ = ["load", "load_all", "dump", "dump_all", "resolve_plain"]

# YAML 1.1 implicit resolvers, as PyYAML's ``Resolver`` has them
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)"
                       r"|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                           r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                           r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                           r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
# the characters PyYAML's reader accepts unescaped
_PRINTABLE_RE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                           "\U00010000-\U0010FFFF]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
            "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# YAML 1.1's line breaks besides '\n' and '\r' (written escaped, never read raw)
_OTHER_BREAKS_RE = re.compile("[\x85\u2028\u2029]")
_FLOW_STOP = ",[]{}"


def _sexagesimal(value: str, conv) -> Any:
    digits = [conv(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def resolve_plain(text: str, line: int = 0) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers
    (PyYAML's ``SafeConstructor``)."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT_RE.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT_RE.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _TIMESTAMP_RE.match(text):
        raise BadConfigSource(f"line {line}: timestamps are outside the supported YAML "
                              f"subset: {text!r}")
    if text in ("<<", "="):
        raise BadConfigSource(f"line {line}: merge and value keys are outside the supported "
                              f"YAML subset")
    return text


class _Reader:
    """One document: block structure by lines, flow and quoted content by
    characters over the same text."""

    def __init__(self, lines: List[str], first_line: int):
        self.lines = lines
        self.first = first_line  # 1-based number of lines[0] in the source
        self.text = "\n".join(lines)
        self.starts = []
        pos = 0
        for ln in lines:
            self.starts.append(pos)
            pos += len(ln) + 1

    # -- helpers ---------------------------------------------------------
    def fail(self, li: int, msg: str):
        raise BadConfigSource(f"line {self.first + li}: {msg}")

    def indent(self, li: int) -> int:
        ln = self.lines[li]
        n = len(ln) - len(ln.lstrip(" "))
        if n < len(ln) and ln[n] == "\t":
            self.fail(li, "a tab in indentation is outside the supported YAML subset")
        return n

    def blank(self, li: int) -> bool:
        s = self.lines[li].strip(" \t")
        return not s or s.startswith("#")

    def next_content(self, li: int) -> Optional[int]:
        while li < len(self.lines):
            if not self.blank(li):
                return li
            li += 1
        return None

    def pos(self, li: int, col: int) -> int:
        return self.starts[li] + col

    def line_of(self, pos: int) -> int:
        lo, hi = 0, len(self.starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.starts[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo

    @staticmethod
    def strip_comment(s: str) -> str:
        """``s`` up to a ``#`` that starts a comment (at its start or after
        a blank), outside quotes are not considered: plain text only."""
        for i, ch in enumerate(s):
            if ch == "#" and (i == 0 or s[i - 1] in " \t"):
                return s[:i]
        return s

    def rest_blank(self, pos: int) -> None:
        """Only blanks or a comment may follow a node on its last line."""
        li = self.line_of(pos)
        rest = self.text[pos:self.starts[li] + len(self.lines[li])]
        if rest.strip(" \t") and not rest.lstrip(" \t").startswith("#"):
            self.fail(li, f"unexpected text after a value: {rest.strip()!r}")
        if rest.strip(" \t") and rest[0] not in " \t":
            self.fail(li, "a comment must be separated from a value by a blank")

    @staticmethod
    def is_seq_entry(s: str) -> bool:
        return s == "-" or s.startswith(("- ", "-\t"))

    def check_start(self, li: int, ch: str, nxt: str, flow: bool) -> None:
        if ch in "&*":
            self.fail(li, "anchors and aliases are outside the supported YAML subset")
        if ch == "!":
            self.fail(li, "tags are outside the supported YAML subset")
        if ch in "%@`":
            self.fail(li, f"a plain scalar cannot start with {ch!r}")
        if ch == "?" and (nxt in " \t\n" or (flow and nxt in _FLOW_STOP)):
            self.fail(li, "complex ('?') keys are outside the supported YAML subset")
        if ch in "-:" and (nxt in " \t\n" or (flow and nxt in _FLOW_STOP)):
            self.fail(li, f"unexpected {ch!r}")
        if ch in "|>" and flow:
            self.fail(li, "block scalars are not allowed inside a flow collection")

    # -- block structure ---------------------------------------------------
    def map_key(self, li: int, col: int) -> Optional[Tuple[Any, int]]:
        """(key, column after its ':') when lines[li] holds a mapping entry
        at ``col``, else None."""
        s = self.lines[li]
        if col >= len(s):
            return None
        ch = s[col]
        if ch in "\"'":
            value, end = self.quoted(self.pos(li, col))
            if self.line_of(end) != li:
                return None
            j = end - self.starts[li]
            while j < len(s) and s[j] in " \t":
                j += 1
            if j < len(s) and s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \t"):
                return value, j + 1
            return None
        if ch in "[{#":
            return None
        plain = self.strip_comment(s[col:])
        for m in re.finditer(r":(?=[ \t]|$)", plain):
            key = plain[:m.start()].rstrip(" \t")
            if not key:
                self.fail(li, "empty mapping key")
            self.check_start(li, key[0], key[1:2] or "\n", False)
            return resolve_plain(key, self.first + li), col + m.end()
        return None

    def node(self, li: int, col: int, parent: int) -> Tuple[Any, int]:
        """The node whose text starts at (li, col) in block context, inside a
        parent block at indentation ``parent``; returns (value, next line)."""
        s = self.lines[li][col:]
        if self.is_seq_entry(s):
            return self.block_seq(li, col)
        if s[:1] == "?" and s[1:2] in ("", " ", "\t"):
            self.fail(li, "complex ('?') keys are outside the supported YAML subset")
        if self.map_key(li, col) is not None:
            return self.block_map(li, col)
        return self.inline(li, col, parent)

    def block_seq(self, li: int, n: int) -> Tuple[List[Any], int]:
        items: List[Any] = []
        cur: Optional[int] = li
        while cur is not None:
            cur = self.next_content(cur)
            if cur is None:
                break
            ind = self.indent(cur)
            if ind < n:
                break
            if ind > n:
                self.fail(cur, "bad indentation of a sequence entry")
            s = self.lines[cur][n:]
            if not self.is_seq_entry(s):
                break
            rest = self.strip_comment(s[1:])
            if not rest.strip(" \t"):
                nxt = self.next_content(cur + 1)
                if nxt is not None and self.indent(nxt) > n:
                    value, cur = self.node(nxt, self.indent(nxt), n)
                else:
                    value, cur = None, cur + 1
            else:
                ln = self.lines[cur]
                self.lines[cur] = ln[:n] + " " + ln[n + 1:]  # the entry's content is a block
                col = n + 1 + (len(s) - 1 - len(s[1:].lstrip(" \t")))
                if "\t" in self.lines[cur][:col]:
                    self.fail(cur, "a tab in indentation is outside the supported YAML subset")
                value, cur = self.node(cur, col, n)
            items.append(value)
        return items, cur if cur is not None else len(self.lines)

    def block_map(self, li: int, n: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        cur: Optional[int] = li
        while cur is not None:
            cur = self.next_content(cur)
            if cur is None:
                break
            ind = self.indent(cur)
            if ind < n:
                break
            if ind > n:
                self.fail(cur, "bad indentation of a mapping entry")
            if self.is_seq_entry(self.lines[cur][n:]):
                self.fail(cur, "a sequence entry where a mapping key was expected")
            entry = self.map_key(cur, n)
            if entry is None:
                self.fail(cur, "expected a 'key: value' entry")
            key, vcol = entry
            try:
                hash(key)
            except TypeError:
                self.fail(cur, "unhashable mapping key")
            ln = self.lines[cur]
            rest = self.strip_comment(ln[vcol:]) if ln[vcol:].lstrip()[:1] not in "\"'" \
                else ln[vcol:]
            if not rest.strip(" \t"):
                nxt = self.next_content(cur + 1)
                if nxt is not None and self.indent(nxt) > n:
                    value, cur = self.node(nxt, self.indent(nxt), n)
                elif nxt is not None and self.indent(nxt) == n \
                        and self.is_seq_entry(self.lines[nxt][n:]):
                    value, cur = self.block_seq(nxt, n)
                else:
                    value, cur = None, cur + 1
            else:
                col = vcol + len(ln[vcol:]) - len(ln[vcol:].lstrip(" \t"))
                value, cur = self.inline(cur, col, n, in_map=True)
            out[key] = value
        return out, cur if cur is not None else len(self.lines)

    def inline(self, li: int, col: int, parent: int, in_map: bool = False) -> Tuple[Any, int]:
        """A scalar, flow collection or block scalar starting at (li, col)."""
        s = self.lines[li]
        ch, nxt = s[col], s[col + 1:col + 2] or "\n"
        if in_map and self.is_seq_entry(s[col:]):
            self.fail(li, "a block sequence cannot start on its key's line")
        if ch in "|>":
            return self.block_scalar(li, col, parent)
        if ch in "[{":
            value, end = self.flow(self.pos(li, col))
            self.rest_blank(end)
            return value, self.line_of(end) + 1
        if ch in "\"'":
            value, end = self.quoted(self.pos(li, col))
            self.rest_blank(end)
            return value, self.line_of(end) + 1
        self.check_start(li, ch, nxt, False)
        return self.plain_block(li, col, parent)

    def plain_block(self, li: int, col: int, parent: int) -> Tuple[Any, int]:
        first = self.lines[li][col:]
        text = self.strip_comment(first)
        commented = len(text) != len(first)
        text = text.rstrip(" \t")
        if re.search(r":([ \t]|$)", text):
            self.fail(li, "a mapping value is not allowed here")
        parts = [text]
        cur = li + 1
        breaks = 0
        while not commented and cur < len(self.lines):
            ln = self.lines[cur]
            if not ln.strip(" \t"):
                breaks += 1
                cur += 1
                continue
            if self.indent(cur) <= parent or ln.lstrip(" \t").startswith("#"):
                break
            more = self.strip_comment(ln.strip(" \t"))
            commented = len(more) != len(ln.strip(" \t"))
            more = more.rstrip(" \t")
            if re.search(r":([ \t]|$)", more):
                self.fail(cur, "a mapping value is not allowed here")
            parts.append("\n" * breaks if breaks else " ")
            parts.append(more)
            breaks = 0
            cur += 1
        if len(parts) > 1:
            return "".join(parts), cur - breaks if not commented else cur
        return resolve_plain(text, self.first + li), li + 1

    def block_scalar(self, li: int, col: int, parent: int) -> Tuple[str, int]:
        """A ``|`` or ``>`` scalar whose header is at (li, col), as PyYAML's
        ``scan_block_scalar`` reads it."""
        header = self.strip_comment(self.lines[li][col:]).rstrip(" \t")
        folded = header[0] == ">"
        chomp, step = None, None
        for ch in header[1:]:
            if ch in "+-" and chomp is None:
                chomp = ch
            elif ch.isdigit() and ch != "0" and step is None:
                step = int(ch)
            else:
                self.fail(li, f"bad block scalar header {header!r}")
        lines, n_lines = self.lines, len(self.lines)
        min_indent = max(parent + 1, 1)
        cur = li + 1
        if step is not None:
            ind = min_indent + step - 1
        else:
            ind, probe = min_indent, cur
            while probe < n_lines and not lines[probe].strip(" "):
                ind = max(ind, len(lines[probe]))
                probe += 1
            if probe < n_lines:
                ind = max(ind, len(lines[probe]) - len(lines[probe].lstrip(" ")))

        def is_break(i: int) -> bool:
            return not lines[i].strip(" ") and len(lines[i]) <= ind

        def reaches(i: int) -> bool:
            return len(lines[i]) - len(lines[i].lstrip(" ")) >= ind and not is_break(i)

        def take_breaks(i: int) -> Tuple[int, List[str]]:
            out: List[str] = []
            while i < n_lines and is_break(i) and i < n_lines - 1:
                out.append("\n")
                i += 1
            return i, out

        cur, breaks = take_breaks(cur)
        chunks: List[str] = []
        line_break = ""
        while cur < n_lines and reaches(cur):
            chunks.extend(breaks)
            text = lines[cur][ind:]
            leading_non_space = text[:1] not in (" ", "\t")
            chunks.append(text)
            line_break = "\n" if cur < n_lines - 1 else ""
            cur, breaks = take_breaks(cur + 1)
            if cur < n_lines and reaches(cur):
                if folded and line_break and leading_non_space \
                        and lines[cur][ind:ind + 1] not in (" ", "\t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp != "-":
            chunks.append(line_break)
        if chomp == "+":
            chunks.extend(breaks)
        return "".join(chunks), cur

    # -- flow and quoted content ------------------------------------------
    def skip_flow_space(self, pos: int) -> int:
        t = self.text
        while pos < len(t):
            ch = t[pos]
            if ch in " \t\n":
                pos += 1
            elif ch == "#" and (pos == 0 or t[pos - 1] in " \t\n"):
                while pos < len(t) and t[pos] != "\n":
                    pos += 1
            else:
                break
        return pos

    def flow(self, pos: int) -> Tuple[Any, int]:
        t = self.text
        opener = t[pos]
        closer = "]" if opener == "[" else "}"
        out: Any = [] if opener == "[" else {}
        pos += 1
        while True:
            pos = self.skip_flow_space(pos)
            if pos >= len(t):
                self.fail(self.line_of(len(t) - 1), f"unclosed flow collection {opener!r}")
            if t[pos] == closer:
                return out, pos + 1
            if t[pos] in ",]}":
                self.fail(self.line_of(pos), f"unexpected {t[pos]!r} in a flow collection")
            if isinstance(out, list):
                item, pos = self.flow_node(pos)
                pos = self.skip_flow_space(pos)
                if pos < len(t) and t[pos] == ":":
                    self.fail(self.line_of(pos), "single-pair mappings in a flow sequence are "
                                                 "outside the supported YAML subset")
                out.append(item)
            else:
                key, pos = self.flow_node(pos, key=True)
                try:
                    hash(key)
                except TypeError:
                    self.fail(self.line_of(pos), "unhashable mapping key")
                pos = self.skip_flow_space(pos)
                value = None
                if pos < len(t) and t[pos] == ":":
                    pos = self.skip_flow_space(pos + 1)
                    if pos < len(t) and t[pos] not in ",}":
                        value, pos = self.flow_node(pos)
                        pos = self.skip_flow_space(pos)
                out[key] = value
            if pos < len(t) and t[pos] == ",":
                pos += 1
            elif pos < len(t) and t[pos] == closer:
                continue
            else:
                self.fail(self.line_of(min(pos, len(t) - 1)),
                          f"expected ',' or {closer!r} in a flow collection")

    def flow_node(self, pos: int, key: bool = False) -> Tuple[Any, int]:
        t = self.text
        ch = t[pos]
        if ch in "[{":
            if key:
                self.fail(self.line_of(pos), "a collection as a mapping key")
            return self.flow(pos)
        if ch in "\"'":
            return self.quoted(pos)
        self.check_start(self.line_of(pos), ch, t[pos + 1:pos + 2] or "\n", True)
        return self.plain_flow(pos)

    def plain_flow(self, pos: int) -> Tuple[Any, int]:
        t = self.text
        start_line = self.line_of(pos)
        chunks: List[str] = []
        while True:
            seg_start = pos
            while pos < len(t):
                ch = t[pos]
                if ch == "\n" or ch in _FLOW_STOP:
                    break
                if ch == ":" and (pos + 1 >= len(t) or t[pos + 1] in " \t\n" + _FLOW_STOP):
                    break
                if ch == "#" and t[pos - 1] in " \t":
                    break
                pos += 1
            chunks.append(t[seg_start:pos].rstrip(" \t"))
            if pos < len(t) and t[pos] == "\n":
                # a plain scalar continues on the next line unless that ends it
                probe, breaks = pos, 0
                while probe < len(t) and t[probe] in " \t\n":
                    breaks += t[probe] == "\n"
                    probe += 1
                if probe >= len(t) or t[probe] in _FLOW_STOP or t[probe] == "#" or (
                        t[probe] == ":" and (probe + 1 >= len(t)
                                             or t[probe + 1] in " \t\n" + _FLOW_STOP)):
                    break
                chunks.append("\n" * (breaks - 1) if breaks > 1 else " ")
                pos = probe
                continue
            break
        text = "".join(chunks)
        if len(chunks) > 1:
            return text, pos
        return resolve_plain(text, self.first + start_line), pos

    def quoted(self, pos: int) -> Tuple[str, int]:
        """The quoted scalar at ``pos`` (its opening quote) -> (value,
        position after its closing quote), folded over lines as YAML
        folds flow scalars."""
        t = self.text
        q = t[pos]
        double = q == '"'
        pos += 1
        chunks: List[str] = []
        while True:
            if pos >= len(t):
                self.fail(self.line_of(len(t) - 1), "unclosed quoted scalar")
            ch = t[pos]
            if ch == q:
                if not double and t[pos + 1:pos + 2] == "'":
                    chunks.append("'")
                    pos += 2
                    continue
                return "".join(chunks), pos + 1
            if double and ch == "\\":
                esc = t[pos + 1:pos + 2]
                if esc in _ESCAPES:
                    chunks.append(_ESCAPES[esc])
                    pos += 2
                elif esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    code = t[pos + 2:pos + 2 + n]
                    if len(code) != n or not all(c in "0123456789abcdefABCDEF" for c in code):
                        self.fail(self.line_of(pos), f"bad escape \\{esc}{code}")
                    chunks.append(chr(int(code, 16)))
                    pos += 2 + n
                elif esc == "\n":
                    pos += 2
                    pos, breaks = self._breaks(pos)
                    chunks.extend(breaks)
                else:
                    self.fail(self.line_of(pos), f"unknown escape \\{esc}")
                continue
            if ch in " \t\n":
                ws_start = pos
                while pos < len(t) and t[pos] in " \t":
                    pos += 1
                if pos < len(t) and t[pos] == "\n":
                    pos, breaks = self._breaks(pos + 1)
                    chunks.extend(breaks if breaks else [" "])
                else:
                    chunks.append(t[ws_start:pos])
                continue
            chunks.append(ch)
            pos += 1

    def _breaks(self, pos: int) -> Tuple[int, List[str]]:
        """Skip the blanks and empty lines after a line break inside a
        quoted scalar: one '\\n' a further line break."""
        t = self.text
        out: List[str] = []
        while True:
            line_start = pos
            if t.startswith(("---", "..."), pos) and (pos + 3 >= len(t) or t[pos + 3] in " \t\n"):
                self.fail(self.line_of(pos), "a document marker inside a quoted scalar")
            while pos < len(t) and t[pos] in " \t":
                pos += 1
            if pos < len(t) and t[pos] == "\n":
                out.append("\n")
                pos += 1
                continue
            del line_start
            return pos, out


def _documents(text: str) -> List[Tuple[List[str], int]]:
    """The source cut at its document markers: [(lines, first line number)]."""
    if text.startswith("\ufeff"):
        text = text[1:]
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    bad = _PRINTABLE_RE.search(text)
    if bad:
        line = text.count("\n", 0, bad.start()) + 1
        raise BadConfigSource(f"line {line}: unacceptable character {bad.group()!r}")
    other_break = _OTHER_BREAKS_RE.search(text)
    if other_break:
        line = text.count("\n", 0, other_break.start()) + 1
        raise BadConfigSource(f"line {line}: the line breaks U+0085, U+2028 and U+2029 are "
                              f"outside the supported YAML subset")
    docs: List[Tuple[List[str], int]] = []
    cur: List[str] = []
    first = 1
    explicit = False
    for i, ln in enumerate(text.split("\n")):
        if ln.startswith("%"):
            raise BadConfigSource(f"line {i + 1}: directives are outside the supported "
                                  f"YAML subset")
        marker = ln[:3]
        if marker in ("---", "...") and (len(ln) == 3 or ln[3] in " \t"):
            tail = ln[3:].strip(" \t")
            if tail and not tail.startswith("#"):
                raise BadConfigSource(f"line {i + 1}: content on a document marker line is "
                                      f"outside the supported YAML subset")
            cur.append("")  # the line before a marker ended with a line break
            if marker == "---":
                if cur and any(s.strip(" \t") and not s.strip(" \t").startswith("#")
                               for s in cur) or explicit:
                    docs.append((cur, first))
                explicit = True
            else:
                docs.append((cur, first))
                explicit = False
            cur, first = [], i + 2
            continue
        cur.append(ln)
    if explicit or any(s.strip(" \t") and not s.strip(" \t").startswith("#") for s in cur):
        docs.append((cur, first))
    return docs


def _load_doc(lines: List[str], first: int) -> Any:
    r = _Reader(list(lines), first)
    li = r.next_content(0)
    if li is None:
        return None
    value, nxt = r.node(li, r.indent(li), -1)
    rest = r.next_content(nxt) if nxt < len(r.lines) else None
    if rest is not None:
        r.fail(rest, "unexpected content after the document's root node")
    return value


def load_all(stream) -> List[Any]:
    """Every document of a YAML text (or a file object)."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return [_load_doc(lines, first) for lines, first in _documents(text)]


def load(stream) -> Any:
    """The single document of a YAML text (None when it is empty), as
    ``yaml.safe_load`` gives it."""
    docs = load_all(stream)
    if len(docs) > 1:
        raise BadConfigSource("expected a single document, found several")
    return docs[0] if docs else None


# -- writer ---------------------------------------------------------------
_PLAIN_SAFE_RE = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+=()@$%^~ -]*$")


def _plain_ok(s: str) -> bool:
    """True when ``s`` written plain reads back as the same string."""
    if not s or s != s.strip(" ") or not _PLAIN_SAFE_RE.fullmatch(s) or "  " in s:
        return False
    try:
        return resolve_plain(s) == s and not _TIMESTAMP_RE.match(s)
    except BadConfigSource:
        return False


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        code = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif code < 0x20 or code == 0x7F or 0x80 <= code < 0xA0 or ch in "\u2028\u2029" \
                or _PRINTABLE_RE.match(ch) or ch == "\ufeff":
            out.append(f"\\x{code:02X}" if code < 0x100 else
                       f"\\u{code:04X}" if code < 0x10000 else f"\\U{code:08X}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r and "e" in r:
            mant, _, exp = r.partition("e")
            r = f"{mant}.0e{exp if exp[0] in '+-' else '+' + exp}"
        elif "e" in r:
            mant, _, exp = r.partition("e")
            r = f"{mant}e{exp if exp[0] in '+-' else '+' + exp}"
        elif "." not in r:
            r += ".0"
        return r
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise BadConfigSource(f"cannot write {type(v).__name__} as YAML")


def _emit(v: Any, indent: int, out: List[str], prefix: str) -> None:
    """Append ``v``'s lines; ``prefix`` is what its first line starts with
    (a key and ': ', or a sequence dash), the rest indent by ``indent``."""
    pad = " " * indent
    if isinstance(v, dict) and v:
        first = True
        for k, item in v.items():
            if isinstance(k, (dict, list, tuple)):
                raise BadConfigSource("cannot write a collection as a mapping key")
            head = (prefix if first else pad) + _scalar(k) + ":"
            first = False
            _emit_value(item, indent, out, head)
    elif isinstance(v, (list, tuple)) and v:
        first = True
        for item in v:
            head = (prefix if first else pad) + "- "
            first = False
            if isinstance(item, dict) and item or isinstance(item, (list, tuple)) and item:
                _emit(item, indent + 2, out, head)
            else:
                out.append(head + _inline(item))
    else:
        out.append(prefix + _inline(v))


def _emit_value(item: Any, indent: int, out: List[str], head: str) -> None:
    if isinstance(item, dict) and item:
        out.append(head)
        _emit(item, indent + 2, out, " " * (indent + 2))
    elif isinstance(item, (list, tuple)) and item:
        out.append(head)
        _emit(item, indent, out, " " * indent)
    else:
        out.append(head + " " + _inline(item))


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(data: Any, stream=None) -> Optional[str]:
    """Block YAML of ``data`` (dicts, lists, tuples, str, int, float, bool,
    None) in insertion order; written to ``stream`` when one is given."""
    out: List[str] = []
    _emit(data, 0, out, "")
    text = "\n".join(out) + "\n"
    if stream is not None:
        stream.write(text)
        return None
    return text


def dump_all(documents, stream=None) -> Optional[str]:
    """Several documents, each after a ``---`` line."""
    text = "".join("---\n" + dump(d) for d in documents)
    if stream is not None:
        stream.write(text)
        return None
    return text
