"""UTC timestamps from PAM filenames — the dataset's absolute time axis.

Real passive-acoustic deployments encode each file's recording start in
its name; every logger vendor picks a different convention.  This module
turns those names into float **epoch seconds** (UTC), which is the one
representation the rest of the system threads around: the manifest
stores one float per file, record/window/event times are pure arithmetic
on top (``start + offset_samples / fs``), and the labeled sinks write
the axis as CF-style ``seconds since 1970-01-01T00:00:00Z`` so xarray
decodes it to datetime64 without a custom reader.

Built-in conventions (tried in order, first full match wins):

  ==============================  =======================================
  pattern                         example
  ==============================  =======================================
  ``YYYYMMDD[_-T]HHMMSS``         ``site3_20100603_120000.wav``
  ``YYYY-MM-DD[_T]HH-MM-SS``      ``2010-06-03_12-00-00.wav``
  ``YYMMDDHHMMSS`` (SoundTrap)    ``5112.100603120000.wav``
  ==============================  =======================================

When the corpus uses something else, pass an explicit override:

  * a **strptime format** (contains ``%``): converted to a regex,
    searched anywhere in the name, parsed with
    ``datetime.strptime`` — e.g. ``"%Y.%j.%H%M"`` for day-of-year
    loggers;
  * a **regex** with named groups ``year``/``month``/``day`` (and
    optional ``hour``/``minute``/``second``), or day-of-year via
    ``yday`` — full control for pathological names.

Parsing never guesses silently: with an explicit override every file
must parse (a :class:`TimestampParseError` names the offenders); in
``"auto"`` mode a corpus must parse either entirely or not at all —
a *mix* is refused, because a half-timestamped manifest would publish
a silently wrong time axis.
"""
from __future__ import annotations

import datetime
import re

_UTC = datetime.timezone.utc

# (compiled regex, strptime format applied to the joined groups)
_BUILTINS: tuple[tuple[re.Pattern, str], ...] = (
    # 20100603_120000 / 20100603-120000 / 20100603T120000
    (re.compile(r"(?<!\d)(\d{8})[_\-T](\d{6})(?!\d)"), "%Y%m%d%H%M%S"),
    # 2010-06-03_12-00-00 / 2010-06-03T12-00-00 / 2010-06-03T120000
    (re.compile(r"(?<!\d)(\d{4})-(\d{2})-(\d{2})[_T]"
                r"(\d{2})-?(\d{2})-?(\d{2})(?!\d)"), "%Y%m%d%H%M%S"),
    # SoundTrap: <serial>.YYMMDDHHMMSS.wav — the 12-digit run must be
    # delimited by dots so plain serial numbers cannot shadow it
    (re.compile(r"\.(\d{12})\.(?:wav|WAV)"), "%y%m%d%H%M%S"),
)

# strptime directive -> regex fragment, for format-string overrides
_STRPTIME_RX = {
    "%Y": r"\d{4}", "%y": r"\d{2}", "%m": r"\d{2}", "%d": r"\d{2}",
    "%H": r"\d{2}", "%M": r"\d{2}", "%S": r"\d{2}", "%j": r"\d{3}",
}


class TimestampParseError(ValueError):
    """A filename (or set of filenames) did not yield a UTC timestamp."""


def _epoch(dt: datetime.datetime) -> float:
    return dt.replace(tzinfo=_UTC).timestamp()


def _format_to_regex(fmt: str) -> re.Pattern:
    """strptime format -> search regex capturing the whole match."""
    out, i = [], 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            d = fmt[i:i + 2]
            if d == "%%":
                out.append(re.escape("%"))
            elif d in _STRPTIME_RX:
                out.append(_STRPTIME_RX[d])
            else:
                raise TimestampParseError(
                    f"unsupported strptime directive {d!r} in timestamp "
                    f"format {fmt!r} (supported: "
                    f"{sorted(_STRPTIME_RX)})")
            i += 2
        else:
            out.append(re.escape(fmt[i]))
            i += 1
    return re.compile("(" + "".join(out) + ")")


def _parse_regex_groups(rx: re.Pattern, name: str) -> float | None:
    m = rx.search(name)
    if m is None:
        return None
    g = m.groupdict()
    try:
        year = int(g["year"])
        if year < 100:
            year += 2000
        if g.get("yday"):
            dt = datetime.datetime(year, 1, 1) \
                + datetime.timedelta(days=int(g["yday"]) - 1)
            month, day = dt.month, dt.day
        else:
            month, day = int(g["month"]), int(g["day"])
        dt = datetime.datetime(
            year, month, day, int(g.get("hour") or 0),
            int(g.get("minute") or 0), int(g.get("second") or 0))
    except (KeyError, TypeError, ValueError) as e:
        raise TimestampParseError(
            f"regex matched {name!r} but its named groups do not form a "
            f"valid date ({e}); the pattern needs groups "
            f"year/month/day (or year/yday) and optional "
            f"hour/minute/second") from e
    return _epoch(dt)


def parse_timestamp(name: str, pattern: str | None = None) -> float | None:
    """One filename -> UTC epoch seconds, or None when nothing matches.

    ``pattern`` overrides the built-in conventions: a string containing
    ``%`` is a strptime format (searched anywhere in the name), anything
    else is a regex with named date groups (see module docstring).
    """
    if pattern is not None:
        if "%" in pattern:
            m = _format_to_regex(pattern).search(name)
            if m is None:
                return None
            return _epoch(datetime.datetime.strptime(m.group(1), pattern))
        rx = re.compile(pattern)
        if rx.groupindex:
            return _parse_regex_groups(rx, name)
        raise TimestampParseError(
            f"timestamp pattern {pattern!r} is neither a strptime format "
            f"(no '%' directive) nor a regex with named groups "
            f"(year/month/day...); see repro_torch.meta.timestamps")
    for rx, fmt in _BUILTINS:
        m = rx.search(name)
        if m is not None:
            return _epoch(
                datetime.datetime.strptime("".join(m.groups()), fmt))
    return None


def timestamps_for(names, pattern: str | None = None,
                   require: bool = False) -> tuple[float, ...] | None:
    """Per-file UTC starts for a whole corpus, or None.

    ``pattern=None`` is auto mode: all files parse -> the tuple; none
    parse -> None (an untimestamped corpus is fine); a MIX raises,
    naming the unparsed files — a partially-timestamped manifest would
    publish a silently wrong time axis.  With an explicit ``pattern``
    (or ``require=True``) every file must parse.
    """
    names = list(names)
    parsed = [parse_timestamp(n, pattern) for n in names]
    missing = [n for n, t in zip(names, parsed) if t is None]
    if not missing:
        return tuple(parsed)
    if pattern is None and not require and len(missing) == len(names):
        return None
    mode = f"pattern {pattern!r}" if pattern is not None \
        else "auto-detected convention"
    shown = ", ".join(repr(n) for n in missing[:5])
    more = f" (+{len(missing) - 5} more)" if len(missing) > 5 else ""
    raise TimestampParseError(
        f"{len(missing)} of {len(names)} filenames carry no UTC "
        f"timestamp under the {mode}: {shown}{more} — every file must "
        f"parse (or none, for a relative time axis); pass an explicit "
        f"strptime/regex pattern matching this corpus")


def format_utc(epoch: float) -> str:
    """Epoch seconds -> ISO-8601 UTC string (``2010-06-03T12:00:00Z``)."""
    dt = datetime.datetime.fromtimestamp(float(epoch), _UTC)
    txt = dt.strftime("%Y-%m-%dT%H:%M:%S")
    frac = dt.microsecond
    if frac:
        txt += f".{frac:06d}".rstrip("0")
    return txt + "Z"
