"""TLE (two-line element) parsing and ephemeris selection.

Behavioural equivalent of reference src/sgpsdp/sgp_in.c:50-381: checksum
validation, fixed-column field extraction with implied decimal points, unit
conversion to radians / radians-per-minute, and the 225-minute deep-space
ephemeris test.  Pure Python/float64 (host side — orbit propagation feeds
the Doppler correction at 1 Hz, far off the device hot path).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as c


class TleError(ValueError):
    pass


def checksum_good(line: str) -> bool:
    """Modulo-10 TLE checksum ('-' counts as 1), sgp_in.c:50-106."""
    if len(line) < 69:
        return False
    total = 0
    for ch in line[:68]:
        if ch.isdigit():
            total += int(ch)
        elif ch == "-":
            total += 1
    return total % 10 == int(line[68]) if line[68].isdigit() else False


@dataclass
class Tle:
    """Parsed + unit-converted orbital elements (select_ephemeris applied)."""

    sat_name: str
    catnr: int
    epoch: float  # raw YYDDD.DDDDDDDD
    epoch_year: int
    epoch_day: int
    epoch_fod: float
    xndt2o: float  # rad/min^2 (converted)
    xndd6o: float  # rad/min^3 (converted)
    bstar: float  # 1/earth-radii
    xincl: float  # rad
    xnodeo: float  # rad
    eo: float
    omegao: float  # rad
    xmo: float  # rad
    xno: float  # rad/min (converted)
    revnum: int
    meanmo: float  # original rev/day
    deep_space: bool = field(default=False)


def _implied_decimal(mantissa: str, exponent: str) -> float:
    """Fields like ' 32890-4' meaning 0.32890e-4."""
    mantissa = mantissa.strip() or "0"
    sign = -1.0 if mantissa.startswith("-") else 1.0
    digits = mantissa.lstrip("+-")
    value = sign * float(f"0.{digits}" if digits else "0")
    exponent = exponent.strip()
    if exponent and exponent not in ("+", "-"):
        value *= 10.0 ** int(exponent)
    return value


def parse_tle(lines: list[str] | tuple[str, str, str]) -> Tle:
    """Parse a 3-line TLE set (name + 2 element lines) and convert units.

    Raises TleError on checksum failure (reference returns -2).
    """
    if len(lines) == 2:
        name, l1, l2 = "", lines[0], lines[1]
    else:
        name, l1, l2 = lines[0], lines[1], lines[2]
    name = name.strip()
    l1 = l1.rstrip("\r\n").ljust(69)
    l2 = l2.rstrip("\r\n").ljust(69)
    if not (checksum_good(l1) and checksum_good(l2)):
        raise TleError("TLE checksum failed")

    epoch_str = l1[18:32]
    epoch_str = epoch_str[:2] + epoch_str[2:5].replace(" ", "0") + epoch_str[5:]
    epoch = float(epoch_str)
    epoch_year = 2000 + int(epoch_str[:2])
    epoch_day = int(epoch_str[2:5])
    epoch_fod = float("0" + epoch_str[5:14])

    xndt2o = float(l1[33:43])
    xndd6o = _implied_decimal(l1[44:50], l1[50:52])
    bstar = _implied_decimal(l1[53:59], l1[59:61])

    xincl = float(l2[8:16])
    xnodeo = float(l2[17:25])
    eo = max(float("0." + l2[26:33].strip()), 1.0e-6)
    omegao = float(l2[34:42])
    xmo = float(l2[43:51])
    xno = float(l2[52:63])
    try:
        revnum = int(float(l2[63:68].strip() or "0"))
    except ValueError:
        revnum = 0
    try:
        catnr = int(l1[2:7].strip() or "0")
    except ValueError:
        catnr = 0

    # select_ephemeris() unit conversion (sgp_in.c:330-381)
    de2ra = c.de2ra
    meanmo = xno
    temp = c.twopi / c.xmnpda / c.xmnpda
    tle = Tle(
        sat_name=name,
        catnr=catnr,
        epoch=epoch,
        epoch_year=epoch_year,
        epoch_day=epoch_day,
        epoch_fod=epoch_fod,
        xndt2o=xndt2o * temp,
        xndd6o=xndd6o * temp / c.xmnpda,
        bstar=bstar / c.ae,
        xincl=xincl * de2ra,
        xnodeo=xnodeo * de2ra,
        eo=eo,
        omegao=omegao * de2ra,
        xmo=xmo * de2ra,
        xno=xno * temp * c.xmnpda,
        revnum=revnum,
        meanmo=meanmo,
    )

    # deep space if un-perturbed period >= 225 min (0.15625 day)
    a1 = (c.xke / tle.xno) ** c.tothrd
    cosio = np.cos(tle.xincl)
    temp2 = c.ck2 * 1.5 * (3.0 * cosio * cosio - 1.0) / (1.0 - tle.eo * tle.eo) ** 1.5
    del1 = temp2 / (a1 * a1)
    ao = a1 * (1.0 - del1 * (c.tothrd * 0.5 + del1 * (del1 * 1.654320987654321 + 1.0)))
    delo = temp2 / (ao * ao)
    xnodp = tle.xno / (delo + 1.0)
    tle.deep_space = (c.twopi / xnodp / c.xmnpda) >= 0.15625
    return tle
