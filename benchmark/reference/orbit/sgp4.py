"""SGP4 near-Earth orbit propagator (Spacetrack Report #3 / WGS72).

Behavioural equivalent of reference src/sgpsdp/sgp4sdp4.c:22-275 (SGP4),
validated against the classic NORAD test datasets vendored in the
reference's src/sgpsdp/TR/*.res.  Pure float64 host math — propagation
feeds the 1 Hz Doppler updates, not the device hot path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import constants as c
from .timeutil import actan, fmod2p
from .tle import Tle


@dataclass
class SatState:
    """Propagated state: ECI position (km) and velocity (km/s), plus the
    osculating geometry used by observers."""

    pos: tuple[float, float, float]
    vel: tuple[float, float, float]


class Sgp4:
    """Initialise once per TLE, then ``propagate(tsince_minutes)``."""

    def __init__(self, tle: Tle):
        self.tle = tle
        xno, eo, xincl = tle.xno, tle.eo, tle.xincl

        a1 = (c.xke / xno) ** c.tothrd
        cosio = math.cos(xincl)
        theta2 = cosio * cosio
        x3thm1 = 3.0 * theta2 - 1.0
        eosq = eo * eo
        betao2 = 1.0 - eosq
        betao = math.sqrt(betao2)
        del1 = 1.5 * c.ck2 * x3thm1 / (a1 * a1 * betao * betao2)
        ao = a1 * (
            1.0 - del1 * (0.5 * c.tothrd + del1 * (1.0 + 134.0 / 81.0 * del1))
        )
        delo = 1.5 * c.ck2 * x3thm1 / (ao * ao * betao * betao2)
        xnodp = xno / (1.0 + delo)
        aodp = ao / (1.0 - delo)

        # "simple" flag for low-perigee sats (sgp4sdp4.c:60-68)
        self.isimp = (aodp * (1.0 - eo) / c.ae) < (220.0 / c.xkmper + c.ae)

        s4 = c.s_const
        qoms24 = c.qoms2t
        perige = (aodp * (1.0 - eo) - c.ae) * c.xkmper
        if perige < 156.0:
            s4 = 20.0 if perige <= 98.0 else perige - 78.0
            qoms24 = ((120.0 - s4) * c.ae / c.xkmper) ** 4
            s4 = s4 / c.xkmper + c.ae

        pinvsq = 1.0 / (aodp * aodp * betao2 * betao2)
        tsi = 1.0 / (aodp - s4)
        eta = aodp * eo * tsi
        etasq = eta * eta
        eeta = eo * eta
        psisq = abs(1.0 - etasq)
        coef = qoms24 * tsi**4
        coef1 = coef / psisq**3.5
        c2 = coef1 * xnodp * (
            aodp * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.75 * c.ck2 * tsi / psisq * x3thm1 * (8.0 + 3.0 * etasq * (8.0 + etasq))
        )
        self.c1 = tle.bstar * c2
        sinio = math.sin(xincl)
        a3ovk2 = -c.xj3 / c.ck2 * c.ae**3
        c3 = coef * tsi * a3ovk2 * xnodp * c.ae * sinio / eo
        x1mth2 = 1.0 - theta2
        self.c4 = (
            2.0 * xnodp * coef1 * aodp * betao2
            * (
                eta * (2.0 + 0.5 * etasq)
                + eo * (0.5 + 2.0 * etasq)
                - 2.0 * c.ck2 * tsi / (aodp * psisq)
                * (
                    -3.0 * x3thm1 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                    + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
                    * math.cos(2.0 * tle.omegao)
                )
            )
        )
        self.c5 = (
            2.0 * coef1 * aodp * betao2 * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq)
        )
        theta4 = theta2 * theta2
        temp1 = 3.0 * c.ck2 * pinvsq * xnodp
        temp2 = temp1 * c.ck2 * pinvsq
        temp3 = 1.25 * c.ck4 * pinvsq * pinvsq * xnodp
        self.xmdot = (
            xnodp
            + 0.5 * temp1 * betao * x3thm1
            + 0.0625 * temp2 * betao * (13.0 - 78.0 * theta2 + 137.0 * theta4)
        )
        x1m5th = 1.0 - 5.0 * theta2
        self.omgdot = (
            -0.5 * temp1 * x1m5th
            + 0.0625 * temp2 * (7.0 - 114.0 * theta2 + 395.0 * theta4)
            + temp3 * (3.0 - 36.0 * theta2 + 49.0 * theta4)
        )
        xhdot1 = -temp1 * cosio
        self.xnodot = (
            xhdot1
            + (0.5 * temp2 * (4.0 - 19.0 * theta2) + 2.0 * temp3 * (3.0 - 7.0 * theta2))
            * cosio
        )
        self.omgcof = tle.bstar * c3 * math.cos(tle.omegao)
        self.xmcof = -c.tothrd * coef * tle.bstar * c.ae / eeta
        self.xnodcf = 3.5 * betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        self.xlcof = (
            0.125 * a3ovk2 * sinio * (3.0 + 5.0 * cosio) / (1.0 + cosio)
        )
        self.aycof = 0.25 * a3ovk2 * sinio
        self.delmo = (1.0 + eta * math.cos(tle.xmo)) ** 3
        self.sinmo = math.sin(tle.xmo)
        self.x7thm1 = 7.0 * theta2 - 1.0
        self.eta = eta
        self.aodp = aodp
        self.xnodp = xnodp
        self.cosio, self.sinio = cosio, sinio
        self.x3thm1, self.x1mth2 = x3thm1, x1mth2

        if not self.isimp:
            c1sq = self.c1 * self.c1
            self.d2 = 4.0 * aodp * tsi * c1sq
            temp = self.d2 * tsi * self.c1 / 3.0
            self.d3 = (17.0 * aodp + s4) * temp
            self.d4 = 0.5 * temp * aodp * tsi * (221.0 * aodp + 31.0 * s4) * self.c1
            self.t3cof = self.d2 + 2.0 * c1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.c1 * (12.0 * self.d2 + 10.0 * c1sq))
            self.t5cof = 0.2 * (
                3.0 * self.d4
                + 12.0 * self.c1 * self.d3
                + 6.0 * self.d2 * self.d2
                + 15.0 * c1sq * (2.0 * self.d2 + c1sq)
            )

    def propagate(self, tsince: float) -> SatState:
        """Propagate ``tsince`` minutes from epoch; returns km and km/s."""
        tle = self.tle
        xmdf = tle.xmo + self.xmdot * tsince
        omgadf = tle.omegao + self.omgdot * tsince
        xnoddf = tle.xnodeo + self.xnodot * tsince
        omega = omgadf
        xmp = xmdf
        tsq = tsince * tsince
        xnode = xnoddf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * tsince
        tempe = tle.bstar * self.c4 * tsince
        templ = self.t2cof * tsq
        if not self.isimp:
            delomg = self.omgcof * tsince
            delm = self.xmcof * ((1.0 + self.eta * math.cos(xmdf)) ** 3 - self.delmo)
            temp = delomg + delm
            xmp = xmdf + temp
            omega = omgadf - temp
            tcube = tsq * tsince
            tfour = tsince * tcube
            tempa -= self.d2 * tsq + self.d3 * tcube + self.d4 * tfour
            tempe += tle.bstar * self.c5 * (math.sin(xmp) - self.sinmo)
            templ += self.t3cof * tcube + self.t4cof * tfour + self.t5cof * tsince * tfour
        a = self.aodp * tempa * tempa
        e = tle.eo - tempe
        xl = xmp + omega + xnode + self.xnodp * templ
        xn = c.xke / a**1.5

        return _short_period(
            self, a, e, xl, xn, xnode, omega,
            self.cosio, self.sinio, tle.xincl,
        )


def _short_period(model, a, e, xl, xn, xnode, omega, cosio, sinio, xincl) -> SatState:
    """Long-period periodics + Kepler solve + short-period periodics.

    Shared by SGP4 and SDP4 (reference sgp4sdp4.c:180-275 / :430-510)."""
    beta = math.sqrt(1.0 - e * e)
    axn = e * math.cos(omega)
    temp = 1.0 / (a * beta * beta)
    xll = temp * model.xlcof * axn
    aynl = temp * model.aycof
    xlt = xl + xll
    ayn = e * math.sin(omega) + aynl

    capu = fmod2p(xlt - xnode)
    epw = capu
    for _ in range(10):
        sinepw = math.sin(epw)
        cosepw = math.cos(epw)
        temp3 = axn * sinepw
        temp4 = ayn * cosepw
        temp5 = axn * cosepw
        temp6 = ayn * sinepw
        new_epw = (capu - temp4 + temp3 - epw) / (1.0 - temp5 - temp6) + epw
        if abs(new_epw - epw) <= c.e6a:
            epw = new_epw
            sinepw = math.sin(epw)
            cosepw = math.cos(epw)
            temp3 = axn * sinepw
            temp4 = ayn * cosepw
            temp5 = axn * cosepw
            temp6 = ayn * sinepw
            break
        epw = new_epw

    ecose = temp5 + temp6
    esine = temp3 - temp4
    elsq = axn * axn + ayn * ayn
    temp = 1.0 - elsq
    pl = a * temp
    r = a * (1.0 - ecose)
    temp1 = 1.0 / r
    rdot = c.xke * math.sqrt(a) * esine * temp1
    rfdot = c.xke * math.sqrt(pl) * temp1
    temp2 = a * temp1
    betal = math.sqrt(temp)
    temp3 = 1.0 / (1.0 + betal)
    cosu = temp2 * (cosepw - axn + ayn * esine * temp3)
    sinu = temp2 * (sinepw - ayn - axn * esine * temp3)
    u = actan(sinu, cosu)
    sin2u = 2.0 * sinu * cosu
    cos2u = 2.0 * cosu * cosu - 1.0
    temp = 1.0 / pl
    temp1 = c.ck2 * temp
    temp2 = temp1 * temp

    rk = (
        r * (1.0 - 1.5 * temp2 * betal * model.x3thm1)
        + 0.5 * temp1 * model.x1mth2 * cos2u
    )
    uk = u - 0.25 * temp2 * model.x7thm1 * sin2u
    xnodek = xnode + 1.5 * temp2 * cosio * sin2u
    xinck = xincl + 1.5 * temp2 * cosio * sinio * cos2u
    rdotk = rdot - xn * temp1 * model.x1mth2 * sin2u
    rfdotk = rfdot + xn * temp1 * (model.x1mth2 * cos2u + 1.5 * model.x3thm1)

    sinuk = math.sin(uk)
    cosuk = math.cos(uk)
    sinik = math.sin(xinck)
    cosik = math.cos(xinck)
    sinnok = math.sin(xnodek)
    cosnok = math.cos(xnodek)
    xmx = -sinnok * cosik
    xmy = cosnok * cosik
    ux = xmx * sinuk + cosnok * cosuk
    uy = xmy * sinuk + sinnok * cosuk
    uz = sinik * sinuk
    vx = xmx * cosuk - cosnok * sinuk
    vy = xmy * cosuk - sinnok * sinuk
    vz = sinik * cosuk

    # Convert_Sat_State: er -> km, er/min -> km/s (sgp_math.c)
    kmps = c.xkmper / c.secday * c.xmnpda
    return SatState(
        pos=(rk * ux * c.xkmper, rk * uy * c.xkmper, rk * uz * c.xkmper),
        vel=(
            (rdotk * ux + rfdotk * vx) * kmps,
            (rdotk * uy + rfdotk * vy) * kmps,
            (rdotk * uz + rfdotk * vz) * kmps,
        ),
    )
