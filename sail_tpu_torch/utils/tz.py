"""Session timezone context (spark.sql.session.timeZone).

Spark interprets naive timestamp literals, string→timestamp casts, and
make_timestamp without an explicit zone in the SESSION timezone, and
renders timestamps in it. The engine stores timestamps as UTC
microseconds; this contextvar carries the session zone through literal
resolution, host datetime functions, and display."""

from __future__ import annotations

import contextvars
import datetime
import zoneinfo

_SESSION_TZ = contextvars.ContextVar("sail_session_tz", default="UTC")


def set_session_timezone(tz: str):
    return _SESSION_TZ.set(tz or "UTC")


def reset_session_timezone(token):
    _SESSION_TZ.reset(token)


def session_timezone_name() -> str:
    return _SESSION_TZ.get()


def session_zone():
    name = _SESSION_TZ.get()
    if name.upper() == "UTC":
        return datetime.timezone.utc
    return zoneinfo.ZoneInfo(name)


def localize(naive: datetime.datetime) -> datetime.datetime:
    """Interpret a naive timestamp in the session zone → aware."""
    return naive.replace(tzinfo=session_zone())


_TRANSITIONS_CACHE = {}


def utc_offset_transitions(name: str = None):
    """(starts_us, offsets_us) numpy arrays for the session zone: UTC→local
    offset as a step function over 1900–2100. Lets device kernels convert
    epoch-us to local time with a searchsorted + gather instead of per-row
    host callbacks. Each step starts at the UTC instant of the change: the
    offset is asked of the instant (``astimezone``), not of its UTC wall
    time (``zone.utcoffset`` of a UTC datetime reads its fields as local
    and would place each change hours off)."""
    import numpy as np

    name = name or session_timezone_name()
    hit = _TRANSITIONS_CACHE.get(name)
    if hit is not None:
        return hit
    zone = (datetime.timezone.utc if name.upper() == "UTC"
            else zoneinfo.ZoneInfo(name))
    if zone is datetime.timezone.utc:
        out = (np.asarray([-(2**62)], dtype=np.int64),
               np.asarray([0], dtype=np.int64))
        _TRANSITIONS_CACHE[name] = out
        return out
    starts = [-(2**62)]
    offsets = []
    t = datetime.datetime(1900, 1, 1, tzinfo=datetime.timezone.utc)
    end = datetime.datetime(2100, 1, 1, tzinfo=datetime.timezone.utc)
    cur = t.astimezone(zone).utcoffset()
    offsets.append(int(cur.total_seconds() * 1e6))
    # scan in 6h steps, bisect each change to the exact second
    step = datetime.timedelta(hours=6)
    while t < end:
        nxt = t + step
        off = nxt.astimezone(zone).utcoffset()
        if off != cur:
            lo, hi = t, nxt
            while hi - lo > datetime.timedelta(seconds=1):
                mid = lo + (hi - lo) / 2
                if mid.astimezone(zone).utcoffset() != cur:
                    hi = mid
                else:
                    lo = mid
            epoch = hi.timestamp()
            starts.append(int(round(epoch)) * 1_000_000)
            offsets.append(int(off.total_seconds() * 1e6))
            cur = off
        t = nxt
    out = (np.asarray(starts, dtype=np.int64),
           np.asarray(offsets, dtype=np.int64))
    _TRANSITIONS_CACHE[name] = out
    return out
