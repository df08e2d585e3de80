"""Solar position and satellite eclipse status.

Behavioural equivalent of reference src/sgpsdp/solar.c (Kelso, low-precision
solar ephemeris + umbra/penumbra geometry), used for pass visibility.
"""

from __future__ import annotations

import math

from sdrmodem_tpu_torch.orbit import constants as c


def delta_et(year: float) -> float:
    """UT -> ET (TDT) difference, least-squares fit 1950-1991 (sgp_time.c)."""
    return (
        26.465
        + 0.747622 * (year - 1950)
        + 1.886913 * math.sin(c.twopi * (year - 1975) / 33.0)
    )


def _modulus(a: float, b: float) -> float:
    r = math.fmod(a, b)
    return r + b if r < 0 else r


def solar_position(jul_utc: float) -> tuple[float, float, float, float]:
    """Solar ECI position vector (km) and magnitude at a Julian date."""
    mjd = jul_utc - 2415020.0
    year = 1900 + mjd / 365.25
    t = (mjd + delta_et(year) / c.secday) / 36525.0
    m = math.radians(
        _modulus(
            358.47583 + _modulus(35999.04975 * t, 360.0) - (0.000150 + 0.0000033 * t) * t * t,
            360.0,
        )
    )
    ll = math.radians(
        _modulus(279.69668 + _modulus(36000.76892 * t, 360.0) + 0.0003025 * t * t, 360.0)
    )
    e = 0.01675104 - (0.0000418 + 0.000000126 * t) * t
    cc = math.radians(
        (1.919460 - (0.004789 + 0.000014 * t) * t) * math.sin(m)
        + (0.020094 - 0.000100 * t) * math.sin(2 * m)
        + 0.000293 * math.sin(3 * m)
    )
    o = math.radians(_modulus(259.18 - 1934.142 * t, 360.0))
    lsa = _modulus(ll + cc - math.radians(0.00569 - 0.00479 * math.sin(o)), c.twopi)
    nu = _modulus(m + cc, c.twopi)
    r = 1.0000002 * (1 - e * e) / (1 + e * math.cos(nu))
    eps = math.radians(
        23.452294 - (0.0130125 + (0.00000164 - 0.000000503 * t) * t) * t
        + 0.00256 * math.cos(o)
    )
    r = c.AU * r
    x = r * math.cos(lsa)
    y = r * math.sin(lsa) * math.cos(eps)
    z = r * math.sin(lsa) * math.sin(eps)
    return x, y, z, r


def sat_eclipsed(pos, pos_mag: float, sol) -> tuple[bool, float]:
    """(eclipsed?, depth) for a satellite ECI position vs the solar vector."""
    sx, sy, sz, sw = sol
    sd_earth = math.asin(c.xkmper / pos_mag)
    rho = (sx - pos[0], sy - pos[1], sz - pos[2])
    rho_mag = math.sqrt(sum(v * v for v in rho))
    sd_sun = math.asin(c.sr / rho_mag)
    earth = (-pos[0], -pos[1], -pos[2])
    dot = sum(a * b for a, b in zip(sol[:3], earth))
    delta = math.acos(dot / (sw * pos_mag))
    depth = sd_earth - sd_sun - delta
    if sd_earth < sd_sun:
        return False, depth
    return depth >= 0, depth
