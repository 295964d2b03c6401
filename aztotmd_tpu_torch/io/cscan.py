"""C-scanf-compatible text scanner used by the deck parsers.

The reference reads all its input decks (control.txt, field.txt, cuda.txt)
with rewind-and-fscanf helpers (reference: src/utils.cpp:87-195): a directive
is located by rewinding the file and repeatedly trying
``fscanf(f, " keyword %d", &x)``, skipping one whitespace token on failure.
This module reproduces those semantics exactly — including the quirks:

* ``%d`` consumes only the integer prefix of a token ("0.2" parses as 0 and
  leaves ".2" in the stream),
* a failed literal match leaves the matched prefix consumed,
* ``%Ns`` reads at most N characters of a token.

so that any deck accepted by the reference parses to the same values here.
"""

from __future__ import annotations

import re

_INT_RE = re.compile(r"[+-]?\d+")
_FLOAT_RE = re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?")
_WS = " \t\r\n\f\v"


class ScanError(Exception):
    """A conversion failed (C fscanf would have returned a short count)."""


class CScan:
    """Position-tracked scanner over deck text with fscanf-like operations."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    # -- primitives ---------------------------------------------------------

    def eof(self) -> bool:
        return self.pos >= len(self.text)

    def rewind(self) -> None:
        self.pos = 0

    def skip_ws(self) -> None:
        t, n = self.text, len(self.text)
        p = self.pos
        while p < n and t[p] in _WS:
            p += 1
        self.pos = p

    def match_literal(self, lit: str) -> bool:
        """Match literal characters (no whitespace inside); consume the
        matched prefix even on failure, like fscanf does."""
        t, n = self.text, len(self.text)
        p = self.pos
        for ch in lit:
            if p >= n or t[p] != ch:
                self.pos = p
                return False
            p += 1
        self.pos = p
        return True

    def read_int(self):
        self.skip_ws()
        m = _INT_RE.match(self.text, self.pos)
        if not m:
            raise ScanError(f"expected int at {self.pos}")
        self.pos = m.end()
        return int(m.group())

    def read_float(self):
        self.skip_ws()
        m = _FLOAT_RE.match(self.text, self.pos)
        if not m:
            raise ScanError(f"expected float at {self.pos}")
        self.pos = m.end()
        return float(m.group().replace("d", "e").replace("D", "e"))

    def read_str(self, width: int | None = None):
        self.skip_ws()
        t, n = self.text, len(self.text)
        p = self.pos
        start = p
        while p < n and t[p] not in _WS and (width is None or p - start < width):
            p += 1
        if p == start:
            raise ScanError(f"expected token at {self.pos}")
        self.pos = p
        return t[start:p]

    # -- fscanf emulation ---------------------------------------------------

    def scanf(self, fmt: str):
        """Emulate ``fscanf(f, fmt, ...)`` at the current position.

        Returns the list of converted values.  Like fscanf, stops at the
        first failing conversion (the consumed prefix stays consumed) and
        returns what was read so far.  Supported conversions: %d %lf %f %s
        with optional width on %s.
        """
        vals = []
        i, n = 0, len(fmt)
        while i < n:
            c = fmt[i]
            if c in _WS:
                self.skip_ws()
                i += 1
            elif c == "%":
                j = i + 1
                while j < n and fmt[j].isdigit():
                    j += 1
                width = int(fmt[i + 1:j]) if j > i + 1 else None
                conv = fmt[j]
                if conv == "l":             # %lf
                    conv = fmt[j + 1]
                    j += 1
                i = j + 1
                try:
                    if conv == "d":
                        vals.append(self.read_int())
                    elif conv in ("f", "e", "g"):
                        vals.append(self.read_float())
                    elif conv == "s":
                        vals.append(self.read_str(width))
                    else:
                        raise ValueError(f"unsupported conversion %{conv}")
                except ScanError:
                    return vals
            else:
                if not self.match_literal(c):
                    return vals
                i += 1
        return vals

    def _n_convs(self, fmt: str) -> int:
        return len(re.findall(r"%\d*(?:l?[dfegs])", fmt))

    def find(self, fmt: str):
        """Emulate the reference ``find_*`` helpers (utils.cpp:87-195):
        rewind, then repeatedly try ``scanf(fmt)``; on failure skip one
        whitespace-delimited token and retry.  Returns the list of converted
        values on success or None if the template never matches."""
        want = self._n_convs(fmt)
        self.rewind()
        while not self.eof():
            vals = self.scanf(fmt)
            if len(vals) >= want and want > 0:
                return vals
            try:
                self.read_str()             # skip one token, like %s
            except ScanError:
                break
        return None

    # typed wrappers mirroring utils.cpp names ------------------------------

    def find_int(self, fmt: str, default=None):
        v = self.find(fmt)
        return int(v[0]) if v else default

    def find_number(self, fmt: str) -> int:
        """find_int returning 0 when absent (utils.cpp:105-118)."""
        v = self.find(fmt)
        return int(v[0]) if v else 0

    def find_double(self, fmt: str, default=None):
        v = self.find(fmt)
        return float(v[0]) if v else default

    def find_str(self, fmt: str, default=None):
        v = self.find(fmt)
        return v[0] if v else default
