"""printf-style format-specifier parsing, validation and application.

Rebuilds SURVEY.md component #5, the reference's ``acg/fmtspec.c``:
``fmtspec_parse`` (``fmtspec.h:224``) decomposes a printf conversion
specification into flags / width / precision / length / conversion,
``fmtspecstr`` rebuilds the string, and the driver uses the parse to
validate ``--numfmt`` before any output is produced.  Here the same
surface is a frozen dataclass with :func:`parse` / ``str()`` round-trip,
plus :meth:`FmtSpec.format` so a validated spec can be *applied* --
including C conversions Python's ``%`` operator lacks (``%a``/``%A``
hexadecimal floating point).

Grammar (C11 fprintf): ``%[flags][width][.precision][length]conversion``
with flags ``-+ #0`` (repeatable), width ``\\d+`` or ``*``, precision
``.\\d*`` or ``.*`` (bare ``.`` means 0), length ``hh h l ll j z t L``,
conversion one of ``d i u o x X f F e E g G a A c s p n %``.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = ["Flags", "FmtSpec", "parse", "parse_prefix", "FmtSpecError",
           "STAR", "FLOAT_CONVERSIONS", "INT_CONVERSIONS"]


class FmtSpecError(ValueError):
    """Invalid format specification (the reference returns EINVAL)."""


class Flags(enum.IntFlag):
    """Conversion flags (``fmtspec.h:38-69``)."""

    NONE = 0
    MINUS = 1 << 0        # '-' left-justify
    PLUS = 1 << 1         # '+' always sign
    SPACE = 1 << 2        # ' ' blank for plus
    NUMBER_SIGN = 1 << 3  # '#' alternative form
    ZERO = 1 << 4         # '0' zero-pad


_FLAG_CHARS = {"-": Flags.MINUS, "+": Flags.PLUS, " ": Flags.SPACE,
               "#": Flags.NUMBER_SIGN, "0": Flags.ZERO}
_FLAG_ORDER = "-+ #0"

# width/precision given as a '*' argument (fmtspec_width_star)
STAR = "*"

# length modifiers, longest first so "ll" wins over "l" (fmtspec.h:135-152)
_LENGTHS = ("hh", "ll", "h", "l", "j", "z", "t", "L")

CONVERSIONS = "diuoxXfFeEgGaAcspn%"
FLOAT_CONVERSIONS = frozenset("fFeEgGaA")
INT_CONVERSIONS = frozenset("diuoxX")


@dataclasses.dataclass(frozen=True)
class FmtSpec:
    """One printf conversion specification (``struct fmtspec``,
    ``fmtspec.h:186-192``)."""

    flags: Flags = Flags.NONE
    width: int | str | None = None      # None, int >= 0, or STAR
    precision: int | str | None = None  # None, int >= 0, or STAR
    length: str = ""                    # "", "hh", "h", "l", "ll", "j", "z", "t", "L"
    conversion: str = "g"

    def __post_init__(self):
        if self.conversion not in CONVERSIONS or len(self.conversion) != 1:
            raise FmtSpecError(f"invalid conversion {self.conversion!r}")
        if self.length and self.length not in _LENGTHS:
            raise FmtSpecError(f"invalid length modifier {self.length!r}")
        for name, v in (("width", self.width), ("precision", self.precision)):
            if not (v is None or v == STAR
                    or (isinstance(v, int) and v >= 0)):
                raise FmtSpecError(f"invalid {name} {v!r}")

    # -- classification ---------------------------------------------------

    @property
    def is_float(self) -> bool:
        return self.conversion in FLOAT_CONVERSIONS

    @property
    def is_integer(self) -> bool:
        return self.conversion in INT_CONVERSIONS

    @property
    def needs_star_args(self) -> bool:
        return STAR in (self.width, self.precision)

    # -- string round-trip (fmtspecstr) ------------------------------------

    def __str__(self) -> str:
        out = ["%"]
        out += [c for c in _FLAG_ORDER if _FLAG_CHARS[c] & self.flags]
        if self.width is not None:
            out.append(str(self.width))
        if self.precision is not None:
            out.append(f".{self.precision}")
        out.append(self.length)
        out.append(self.conversion)
        return "".join(out)

    # -- application -------------------------------------------------------

    def format(self, value, *star_args) -> str:
        """Apply the spec to one value (the printf call the reference
        leaves to libc).  ``*star_args`` supply ``*`` width/precision in
        printf argument order."""
        width, precision = self.width, self.precision
        star = list(star_args)
        if width == STAR:
            width = int(star.pop(0))
        if precision == STAR:
            precision = int(star.pop(0))
        if star:
            raise FmtSpecError(f"{len(star)} unused star argument(s)")
        conv = self.conversion
        if conv == "%":
            return self._pad("%", width)
        if conv == "n":
            return ""  # "Nothing printed" (fmtspec.h:177)
        if conv in "aA":
            return self._pad(self._hexfloat(float(value), precision, conv),
                             width)
        if conv == "p":
            return self._pad(hex(int(value)), width)
        # Python's % implements the rest, but rejects C length modifiers
        # and 'i'/'u'; strip/translate those (they change the C argument
        # type, which Python numbers subsume)
        pyconv = {"i": "d", "u": "d", "F": "f"}.get(conv, conv)
        flags = "".join(c for c in _FLAG_ORDER if _FLAG_CHARS[c] & self.flags)
        spec = "%" + flags + ("" if width is None else str(width)) + \
            ("" if precision is None else f".{precision}") + pyconv
        if conv in "diu":
            value = int(value)
        elif self.is_float:
            value = float(value)
        return spec % value

    def _pad(self, s: str, width) -> str:
        if width is None or len(s) >= width:
            return s
        if self.flags & Flags.MINUS:
            return s + " " * (width - len(s))
        if self.flags & Flags.ZERO and self.conversion in "aAp":
            # zero padding goes after the sign and the 0x prefix;
            # inf/nan (no 0x) pad with spaces like printf
            head = len(s) - len(s.lstrip("+- "))
            if s[head:head + 2].lower() == "0x":
                head += 2
                return s[:head] + "0" * (width - len(s)) + s[head:]
        return " " * (width - len(s)) + s

    def _hexfloat(self, v: float, precision, conv: str) -> str:
        """C17 %a: [-]0xh.hhhp±d.  float.hex() already emits the C
        shape for normal numbers; handle sign flags, precision
        rounding, and specials here."""
        import math

        sign = "-" if math.copysign(1.0, v) < 0 else (
            "+" if self.flags & Flags.PLUS else (
                " " if self.flags & Flags.SPACE else ""))
        a = abs(v)
        if math.isnan(a):
            body = "nan"
        elif math.isinf(a):
            body = "inf"
        else:
            h = a.hex()  # "0x1.921fb54442d18p+1" / "0x0.0p+0"
            mant, exp = h.split("p")
            if precision is not None:
                # round the fractional hex digits to `precision` places
                intpart, frac = (mant.split(".") + [""])[:2]
                scaled = int(intpart[2:] + frac, 16)
                drop = 4 * (len(frac) - precision)
                if drop > 0:
                    # round to nearest, ties to even (what printf does)
                    rem = scaled & ((1 << drop) - 1)
                    half = 1 << (drop - 1)
                    scaled >>= drop
                    if rem > half or (rem == half and scaled & 1):
                        scaled += 1
                elif drop < 0:
                    scaled <<= -drop  # pad with trailing hex zeros
                digits = hex(scaled)[2:].rjust(precision + 1, "0")
                if precision == 0:
                    head, tail = digits, ""
                else:
                    head, tail = digits[:-precision] or "0", digits[-precision:]
                mant = "0x" + head + ("." + tail if tail else "")
            elif "." in mant:
                # no precision: exact digits, trailing zeros dropped
                # (glibc's choice; "0x1.8000...0p+0" -> "0x1.8p+0")
                mant = mant.rstrip("0").rstrip(".")
            body = f"{mant}p{int(exp):+d}"
        out = sign + body
        return out.upper() if conv == "A" else out


def parse_prefix(s: str, pos: int = 0) -> tuple[FmtSpec, int]:
    """Parse one conversion specification starting at ``s[pos]``; return
    the spec and the index one past it (the reference's ``endptr``,
    ``fmtspec.h:219-231``)."""
    n = len(s)
    if pos >= n or s[pos] != "%":
        raise FmtSpecError(f"expected '%' at position {pos} in {s!r}")
    i = pos + 1
    flags = Flags.NONE
    while i < n and s[i] in _FLAG_CHARS:
        flags |= _FLAG_CHARS[s[i]]
        i += 1
    width: int | str | None = None
    if i < n and s[i] == "*":
        width, i = STAR, i + 1
    else:
        j = i
        while j < n and s[j].isdigit():
            j += 1
        if j > i:
            width, i = int(s[i:j]), j
    precision: int | str | None = None
    if i < n and s[i] == ".":
        i += 1
        if i < n and s[i] == "*":
            precision, i = STAR, i + 1
        else:
            j = i
            while j < n and s[j].isdigit():
                j += 1
            # a bare '.' means precision 0 (fmtspec.h:120-122)
            precision, i = (int(s[i:j]) if j > i else 0), j
    length = ""
    for mod in _LENGTHS:
        if s.startswith(mod, i):
            length, i = mod, i + len(mod)
            break
    if i >= n or s[i] not in CONVERSIONS:
        got = s[i] if i < n else "<end>"
        raise FmtSpecError(f"invalid conversion character {got!r} in {s!r}")
    return FmtSpec(flags=flags, width=width, precision=precision,
                   length=length, conversion=s[i]), i + 1


def parse(s: str) -> FmtSpec:
    """Parse a string that must be exactly one conversion specification
    (how the driver validates ``--numfmt``)."""
    spec, end = parse_prefix(s, 0)
    if end != len(s):
        raise FmtSpecError(f"trailing characters after conversion: {s[end:]!r}")
    return spec
