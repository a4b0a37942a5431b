"""GPS time <-> UTC conversion (reference gpslib.py:1946-1963, 14-21)."""

from __future__ import annotations

import datetime

from gps_sdr.config import LEAPSEC, ROLLOVER

GPS_EPOCH = datetime.datetime(1980, 1, 6)


def gps_datetime(tow: int, week_num: int) -> datetime.datetime:
    """UTC datetime of the *current* subframe start.

    `tow` counts the start of the NEXT subframe, so the current subframe
    began at (tow-1)*6 s of week; leap seconds and the week-number
    rollover era are applied (reference gpsTime, gpslib.py:1946-1955).
    """
    tow = int(tow)
    week_num = int(week_num)
    return (GPS_EPOCH
            + datetime.timedelta(days=(week_num + ROLLOVER * 1024) * 7)
            + datetime.timedelta(seconds=(tow - 1) * 6 - LEAPSEC))


def gps_time_str(tow: int, week_num: int, time_only: bool = False) -> str:
    d = gps_datetime(tow, week_num)
    fmt = "%H:%M:%S UTC" if time_only else "%a, %d.%m.%Y %H:%M:%S UTC"
    return d.strftime(fmt)


def gps_week_tow(dt: datetime.datetime | None = None) -> tuple[int, int]:
    """(week_num, tow) of a UTC datetime (default: now) — the inverse
    of gps_datetime, for almanac warm starts from wall-clock time.
    week_num is the 10-bit broadcast value (rollover era removed)."""
    if dt is None:
        dt = datetime.datetime.now(datetime.timezone.utc)
    if dt.tzinfo is not None:
        dt = dt.replace(tzinfo=None)
    sec = (dt - GPS_EPOCH).total_seconds() + LEAPSEC
    week = int(sec // 604800)
    tow = int((sec - week * 604800) // 6) + 1
    return week - ROLLOVER * 1024, tow


def posix_from_gps_abs(gps_abs_sec: float) -> float:
    """POSIX timestamp from seconds-since-GPS-epoch (UTC leap-corrected)."""
    return (GPS_EPOCH - datetime.datetime(1970, 1, 1)).total_seconds() \
        + gps_abs_sec - LEAPSEC
