"""Astronomical time utilities (reference src/sgpsdp/sgp_time.c).

Julian dates here follow the sgpsdp convention: astronomical Julian date
minus nothing — i.e. ``julian_date_of_year(y)`` is the Julian date of
0.0 Jan of year y (midnight Dec 31 of y-1).
"""

from __future__ import annotations

import datetime as _dt
import math

from . import constants as c


def julian_date_of_year(year: int) -> float:
    """Julian date of 0.0 Jan of ``year`` (sgp_time.c Julian_Date_of_Year)."""
    year = year - 1
    i = year // 100
    a = i
    i = a // 4
    b = 2 - a + i
    i = math.trunc(365.25 * year)
    i += math.trunc(30.6001 * 14)
    return i + 1720994.5 + b


def julian_date_of_epoch(epoch: float) -> float:
    """TLE epoch (YYDDD.DDDDDDDD) -> Julian date (sgp_time.c:31-55).

    Years 57-99 map to 19xx, 00-56 to 20xx (valid until 2056)."""
    year, day = divmod(epoch * 1e-3, 1.0)
    day *= 1e3
    year = int(year)
    year = 1900 + year if year >= 57 else 2000 + year
    return julian_date_of_year(year) + day


def day_of_year(yr: int, mo: int, dy: int) -> int:
    days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    day = sum(days[: mo - 1]) + dy
    if mo > 2 and ((yr % 4 == 0 and yr % 100 != 0) or yr % 400 == 0):
        day += 1
    return day


def fraction_of_day(hr: int, mi: int, se: float) -> float:
    return (hr + (mi + se / 60.0) / 60.0) / 24.0


def julian_date(t: _dt.datetime | float) -> float:
    """Julian date of a UTC datetime or unix timestamp (sgp_time.c Julian_Date)."""
    if isinstance(t, (int, float)):
        t = _dt.datetime.fromtimestamp(t, _dt.timezone.utc)
    return (
        julian_date_of_year(t.year)
        + day_of_year(t.year, t.month, t.day)
        + fraction_of_day(t.hour, t.minute, t.second + t.microsecond * 1e-6)
    )


def calendar_date(jd: float) -> _dt.datetime:
    """Inverse of julian_date (approximately; sgp_time.c Date_Time)."""
    unix = (jd - 2440587.5) * c.secday
    return _dt.datetime.fromtimestamp(round(unix), _dt.timezone.utc)


def theta_g_jd(jd: float) -> float:
    """Greenwich mean sidereal time (radians) at Julian date jd
    (sgp_time.c ThetaG_JD, Astronomical Almanac formulation)."""
    ut = math.fmod(jd + 0.5, 1.0)
    jd = jd - ut
    tu = (jd - 2451545.0) / 36525.0
    gmst = 24110.54841 + tu * (8640184.812866 + tu * (0.093104 - tu * 6.2e-6))
    gmst = math.fmod(gmst + c.secday * c.omega_E * ut, c.secday)
    return c.twopi * gmst / c.secday


def theta_g(epoch: float) -> tuple[float, float]:
    """GMST at a TLE epoch, plus days since 1950 (sgp_time.c ThetaG).

    Returns (thgr, ds50) — the deep-space initialisation uses the classic
    FMod2p(6.3003880987*ds50 + 1.72944494) formulation, matching the C.
    """
    year, day = divmod(epoch * 1e-3, 1.0)
    day *= 1e3
    year = int(year)
    year = 1900 + year if year >= 57 else 2000 + year
    ut, day = math.modf(day)
    jd = julian_date_of_year(year) + day
    ds50 = jd - 2433281.5 + ut
    return fmod2p(6.3003880987 * ds50 + 1.72944494), ds50


def fmod2p(x: float) -> float:
    """x mod 2pi into [0, 2pi) (sgp_math.c FMod2p)."""
    ret = math.fmod(x, c.twopi)
    if ret < 0.0:
        ret += c.twopi
    return ret


def actan(sinx: float, cosx: float) -> float:
    """Four-quadrant arctan returning [0, 2pi) (sgp_math.c AcTan)."""
    ret = math.atan2(sinx, cosx)
    return ret + c.twopi if ret < 0.0 else ret
