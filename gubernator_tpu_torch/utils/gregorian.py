"""Gregorian calendar interval math (reference: interval.go:72-146).

All functions take a timezone-aware (or naive = local) datetime `now` and
return milliseconds.  Computed host-side, before kernel entry: the kernels
only see a precomputed `greg_expire` / `greg_duration` per request
(reference computes these inline at algorithms.go:90-95,140-145,216-232).

Bug-compat note: the reference's `GregorianDuration` for months/years
computes `end.UnixNano() - begin.UnixNano()/1000000` — nanoseconds minus
milliseconds due to operator precedence (interval.go:97,103).  Since that
value feeds the observable leaky-bucket leak rate under
DURATION_IS_GREGORIAN, we reproduce it exactly rather than "fixing" it.
"""

from __future__ import annotations

import datetime as _dt

# Duration enum values (interval.go:72-79).
GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5

ERR_WEEKS = "`Duration = GregorianWeeks` not yet supported; consider making a PR!`"
ERR_INVALID = (
    "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid gregorian interval"
)


class GregorianError(ValueError):
    pass


def _epoch_seconds(dt: _dt.datetime) -> int:
    # All boundaries used here are whole seconds; float timestamp() is exact
    # for integer epoch-second values in this range.
    return int(dt.timestamp())


def _next_month(dt: _dt.datetime) -> _dt.datetime:
    y, m = dt.year, dt.month
    if m == 12:
        y, m = y + 1, 1
    else:
        m += 1
    return dt.replace(year=y, month=m)


def _boundary_seconds(now: _dt.datetime, d: int) -> int:
    """Epoch seconds of the *next* interval boundary (start of next interval)."""
    if d == GREGORIAN_MINUTES:
        trunc = now.replace(second=0, microsecond=0)
        return _epoch_seconds(trunc) + 60
    if d == GREGORIAN_HOURS:
        trunc = now.replace(minute=0, second=0, microsecond=0)
        return _epoch_seconds(trunc) + 3600
    if d == GREGORIAN_DAYS:
        trunc = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return _epoch_seconds(trunc + _dt.timedelta(days=1))
    if d == GREGORIAN_MONTHS:
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        return _epoch_seconds(_next_month(begin))
    if d == GREGORIAN_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        return _epoch_seconds(begin.replace(year=begin.year + 1))
    if d == GREGORIAN_WEEKS:
        raise GregorianError(ERR_WEEKS)
    raise GregorianError(ERR_INVALID)


def gregorian_expiration(now: _dt.datetime, d: int) -> int:
    """End of the current Gregorian interval, in ms since epoch.

    Matches reference `GregorianExpiration` (interval.go:115-146): the
    boundary minus one nanosecond, floored to milliseconds — i.e.
    `boundary_seconds * 1000 - 1`.
    """
    return _boundary_seconds(now, d) * 1000 - 1


def gregorian_duration(now: _dt.datetime, d: int) -> int:
    """Entire duration of the Gregorian interval (interval.go:82-107).

    Minutes/hours/days are constants in ms.  Months/years reproduce the
    reference's `end_ns - begin_ms` formula (see module docstring).
    """
    if d == GREGORIAN_MINUTES:
        return 60_000
    if d == GREGORIAN_HOURS:
        return 3_600_000
    if d == GREGORIAN_DAYS:
        return 86_400_000
    if d == GREGORIAN_WEEKS:
        raise GregorianError(ERR_WEEKS)
    if d == GREGORIAN_MONTHS:
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        begin_s = _epoch_seconds(begin)
        end_ns = _epoch_seconds(_next_month(begin)) * 1_000_000_000 - 1
        return end_ns - begin_s * 1000
    if d == GREGORIAN_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        begin_s = _epoch_seconds(begin)
        end_ns = _epoch_seconds(begin.replace(year=begin.year + 1)) * 1_000_000_000 - 1
        return end_ns - begin_s * 1000
    raise GregorianError(ERR_INVALID)
