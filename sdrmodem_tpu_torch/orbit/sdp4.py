"""SDP4 deep-space orbit propagator (Spacetrack Report #3 / WGS72).

Behavioural equivalent of reference src/sgpsdp/sgp4sdp4.c:278-1002 (SDP4 +
Deep): lunar/solar secular and periodic perturbations, 12-hour/synchronous
geopotential resonance with the 720-minute secular integrator, and the
Lyddane modification for low-inclination periodics.  Validated against the
classic NORAD SDP4 test dataset (reference src/sgpsdp/TR/test-002-01.res).
"""

from __future__ import annotations

import math

from sdrmodem_tpu_torch.orbit import constants as c
from sdrmodem_tpu_torch.orbit.sgp4 import SatState, _short_period
from sdrmodem_tpu_torch.orbit.timeutil import actan, fmod2p, theta_g
from sdrmodem_tpu_torch.orbit.tle import Tle


class Sdp4:
    def __init__(self, tle: Tle):
        self.tle = tle
        eo, xincl, xno = tle.eo, tle.xincl, tle.xno

        a1 = (c.xke / xno) ** c.tothrd
        self.cosio = math.cos(xincl)
        self.theta2 = self.cosio * self.cosio
        self.x3thm1 = 3.0 * self.theta2 - 1.0
        self.eosq = eo * eo
        self.betao2 = 1.0 - self.eosq
        self.betao = math.sqrt(self.betao2)
        del1 = 1.5 * c.ck2 * self.x3thm1 / (a1 * a1 * self.betao * self.betao2)
        ao = a1 * (1.0 - del1 * (0.5 * c.tothrd + del1 * (1.0 + 134.0 / 81.0 * del1)))
        delo = 1.5 * c.ck2 * self.x3thm1 / (ao * ao * self.betao * self.betao2)
        self.xnodp = xno / (1.0 + delo)
        self.aodp = ao / (1.0 - delo)

        s4 = c.s_const
        qoms24 = c.qoms2t
        perige = (self.aodp * (1.0 - eo) - c.ae) * c.xkmper
        if perige < 156.0:
            s4 = 20.0 if perige <= 98.0 else perige - 78.0
            qoms24 = ((120.0 - s4) * c.ae / c.xkmper) ** 4
            s4 = s4 / c.xkmper + c.ae
        pinvsq = 1.0 / (self.aodp * self.aodp * self.betao2 * self.betao2)
        self.sing = math.sin(tle.omegao)
        self.cosg = math.cos(tle.omegao)
        tsi = 1.0 / (self.aodp - s4)
        eta = self.aodp * eo * tsi
        etasq = eta * eta
        eeta = eo * eta
        psisq = abs(1.0 - etasq)
        coef = qoms24 * tsi**4
        coef1 = coef / psisq**3.5
        c2 = coef1 * self.xnodp * (
            self.aodp * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.75 * c.ck2 * tsi / psisq * self.x3thm1
            * (8.0 + 3.0 * etasq * (8.0 + etasq))
        )
        self.c1 = tle.bstar * c2
        self.sinio = math.sin(xincl)
        a3ovk2 = -c.xj3 / c.ck2 * c.ae**3
        self.x1mth2 = 1.0 - self.theta2
        self.c4 = (
            2.0 * self.xnodp * coef1 * self.aodp * self.betao2
            * (
                eta * (2.0 + 0.5 * etasq)
                + eo * (0.5 + 2.0 * etasq)
                - 2.0 * c.ck2 * tsi / (self.aodp * psisq)
                * (
                    -3.0 * self.x3thm1 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                    + 0.75 * self.x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
                    * math.cos(2.0 * tle.omegao)
                )
            )
        )
        theta4 = self.theta2 * self.theta2
        temp1 = 3.0 * c.ck2 * pinvsq * self.xnodp
        temp2 = temp1 * c.ck2 * pinvsq
        temp3 = 1.25 * c.ck4 * pinvsq * pinvsq * self.xnodp
        self.xmdot = (
            self.xnodp
            + 0.5 * temp1 * self.betao * self.x3thm1
            + 0.0625 * temp2 * self.betao * (13.0 - 78.0 * self.theta2 + 137.0 * theta4)
        )
        x1m5th = 1.0 - 5.0 * self.theta2
        self.omgdot = (
            -0.5 * temp1 * x1m5th
            + 0.0625 * temp2 * (7.0 - 114.0 * self.theta2 + 395.0 * theta4)
            + temp3 * (3.0 - 36.0 * self.theta2 + 49.0 * theta4)
        )
        xhdot1 = -temp1 * self.cosio
        self.xnodot = (
            xhdot1
            + (0.5 * temp2 * (4.0 - 19.0 * self.theta2)
               + 2.0 * temp3 * (3.0 - 7.0 * self.theta2)) * self.cosio
        )
        self.xnodcf = 3.5 * self.betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        self.xlcof = 0.125 * a3ovk2 * self.sinio * (3.0 + 5.0 * self.cosio) / (1.0 + self.cosio)
        self.aycof = 0.25 * a3ovk2 * self.sinio
        self.x7thm1 = 7.0 * self.theta2 - 1.0

        self._deep_init()

    # ------------------------------------------------------------------
    # Deep(dpinit)
    def _deep_init(self):
        tle = self.tle
        self.thgr, self.ds50 = theta_g(tle.epoch)
        eq = tle.eo
        self.xnq = self.xnodp
        aqnv = 1.0 / self.aodp
        self.xqncl = tle.xincl
        xmao = tle.xmo
        xpidot = self.omgdot + self.xnodot
        sinq = math.sin(tle.xnodeo)
        cosq = math.cos(tle.xnodeo)
        self.omegaq = tle.omegao

        # lunar/solar geometry at epoch
        day = self.ds50 + 18261.5  # days since 1900 Jan 0.5
        xnodce = 4.5236020 - 9.2422029e-4 * day
        stem = math.sin(xnodce)
        ctem = math.cos(xnodce)
        zcosil = 0.91375164 - 0.03568096 * ctem
        zsinil = math.sqrt(1.0 - zcosil * zcosil)
        zsinhl = 0.089683511 * stem / zsinil
        zcoshl = math.sqrt(1.0 - zsinhl * zsinhl)
        cval = 4.7199672 + 0.22997150 * day
        gam = 5.8351514 + 0.0019443680 * day
        self.zmol = fmod2p(cval - gam)
        zx = 0.39785416 * stem / zsinil
        zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
        zx = actan(zx, zy)
        zx = gam + zx - xnodce
        zcosgl = math.cos(zx)
        zsingl = math.sin(zx)
        self.zmos = fmod2p(6.2565837 + 0.017201977 * day)

        self.savtsn = 1e20
        zcosg, zsing = c.zcosgs, c.zsings
        zcosi, zsini = c.zcosis, c.zsinis
        zcosh, zsinh = cosq, sinq
        cc, zn, ze = c.c1ss, c.zns, c.zes
        xnoi = 1.0 / self.xnq

        lunar_done = False
        while True:
            a1 = zcosg * zcosh + zsing * zcosi * zsinh
            a3 = -zsing * zcosh + zcosg * zcosi * zsinh
            a7 = -zcosg * zsinh + zsing * zcosi * zcosh
            a8 = zsing * zsini
            a9 = zsing * zsinh + zcosg * zcosi * zcosh
            a10 = zcosg * zsini
            a2 = self.cosio * a7 + self.sinio * a8
            a4 = self.cosio * a9 + self.sinio * a10
            a5 = -self.sinio * a7 + self.cosio * a8
            a6 = -self.sinio * a9 + self.cosio * a10
            x1 = a1 * self.cosg + a2 * self.sing
            x2 = a3 * self.cosg + a4 * self.sing
            x3 = -a1 * self.sing + a2 * self.cosg
            x4 = -a3 * self.sing + a4 * self.cosg
            x5 = a5 * self.sing
            x6 = a6 * self.sing
            x7 = a5 * self.cosg
            x8 = a6 * self.cosg
            z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
            z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
            z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
            z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * self.eosq
            z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * self.eosq
            z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * self.eosq
            z11 = -6.0 * a1 * a5 + self.eosq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
            z12 = -6.0 * (a1 * a6 + a3 * a5) + self.eosq * (
                -24.0 * (x2 * x7 + x1 * x8) - 6.0 * (x3 * x6 + x4 * x5)
            )
            z13 = -6.0 * a3 * a6 + self.eosq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
            z21 = 6.0 * a2 * a5 + self.eosq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
            z22 = 6.0 * (a4 * a5 + a2 * a6) + self.eosq * (
                24.0 * (x2 * x5 + x1 * x6) - 6.0 * (x4 * x7 + x3 * x8)
            )
            z23 = 6.0 * a4 * a6 + self.eosq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
            z1 = z1 + z1 + self.betao2 * z31
            z2 = z2 + z2 + self.betao2 * z32
            z3 = z3 + z3 + self.betao2 * z33
            s3 = cc * xnoi
            s2 = -0.5 * s3 / self.betao
            s4 = s3 * self.betao
            s1 = -15.0 * eq * s4
            s5 = x1 * x3 + x2 * x4
            s6 = x2 * x3 + x1 * x4
            s7 = x2 * x4 - x1 * x3
            se = s1 * zn * s5
            si = s2 * zn * (z11 + z13)
            sl = -zn * s3 * (z1 + z3 - 14.0 - 6.0 * self.eosq)
            sgh = s4 * zn * (z31 + z33 - 6.0)
            sh = -zn * s2 * (z21 + z23)
            if self.xqncl < 5.2359877e-2:
                sh = 0.0
            self.ee2 = 2.0 * s1 * s6
            self.e3 = 2.0 * s1 * s7
            self.xi2 = 2.0 * s2 * z12
            self.xi3 = 2.0 * s2 * (z13 - z11)
            self.xl2 = -2.0 * s3 * z2
            self.xl3 = -2.0 * s3 * (z3 - z1)
            self.xl4 = -2.0 * s3 * (-21.0 - 9.0 * self.eosq) * ze
            self.xgh2 = 2.0 * s4 * z32
            self.xgh3 = 2.0 * s4 * (z33 - z31)
            self.xgh4 = -18.0 * s4 * ze
            self.xh2 = -2.0 * s2 * z22
            self.xh3 = -2.0 * s2 * (z23 - z21)

            if lunar_done:
                break
            # stash solar terms; redo loop with lunar geometry
            self.sse, self.ssi, self.ssl = se, si, sl
            self.ssh = sh / self.sinio
            self.ssg = sgh - self.cosio * self.ssh
            self.se2, self.si2, self.sl2 = self.ee2, self.xi2, self.xl2
            self.sgh2, self.sh2 = self.xgh2, self.xh2
            self.se3, self.si3, self.sl3 = self.e3, self.xi3, self.xl3
            self.sgh3, self.sh3 = self.xgh3, self.xh3
            self.sl4, self.sgh4 = self.xl4, self.xgh4
            zcosg, zsing = zcosgl, zsingl
            zcosi, zsini = zcosil, zsinil
            zcosh = zcoshl * cosq + zsinhl * sinq
            zsinh = sinq * zcoshl - cosq * zsinhl
            zn, cc, ze = c.znl, c.c1l, c.zel
            lunar_done = True

        self.sse += se
        self.ssi += si
        self.ssl += sl
        self.ssg += sgh - self.cosio / self.sinio * sh
        self.ssh += sh / self.sinio

        # geopotential resonance
        self.resonance = False
        self.synchronous = False
        bfact = 0.0
        if 0.0034906585 < self.xnq < 0.0052359877:
            # synchronous (24h) resonance
            self.resonance = True
            self.synchronous = True
            g200 = 1.0 + self.eosq * (-2.5 + 0.8125 * self.eosq)
            g310 = 1.0 + 2.0 * self.eosq
            g300 = 1.0 + self.eosq * (-6.0 + 6.60937 * self.eosq)
            f220 = 0.75 * (1.0 + self.cosio) * (1.0 + self.cosio)
            f311 = (
                0.9375 * self.sinio * self.sinio * (1.0 + 3.0 * self.cosio)
                - 0.75 * (1.0 + self.cosio)
            )
            f330 = 1.0 + self.cosio
            f330 = 1.875 * f330 * f330 * f330
            self.del1 = 3.0 * self.xnq * self.xnq * aqnv * aqnv
            self.del2 = 2.0 * self.del1 * f220 * g200 * c.q22
            self.del3 = 3.0 * self.del1 * f330 * g300 * c.q33 * aqnv
            self.del1 = self.del1 * f311 * g310 * c.q31 * aqnv
            self.fasx2, self.fasx4, self.fasx6 = 0.13130908, 2.8843198, 0.37448087
            self.xlamo = xmao + tle.xnodeo + tle.omegao - self.thgr
            bfact = self.xmdot + xpidot - c.thdt
            bfact += self.ssl + self.ssg + self.ssh
        elif 0.00826 <= self.xnq <= 0.00924 and eq >= 0.5:
            # 12-hour resonance
            self.resonance = True
            eoc = eq * self.eosq
            g201 = -0.306 - (eq - 0.64) * 0.440
            if eq <= 0.65:
                g211 = 3.616 - 13.247 * eq + 16.290 * self.eosq
                g310 = -19.302 + 117.390 * eq - 228.419 * self.eosq + 156.591 * eoc
                g322 = -18.9068 + 109.7927 * eq - 214.6334 * self.eosq + 146.5816 * eoc
                g410 = -41.122 + 242.694 * eq - 471.094 * self.eosq + 313.953 * eoc
                g422 = -146.407 + 841.880 * eq - 1629.014 * self.eosq + 1083.435 * eoc
                g520 = -532.114 + 3017.977 * eq - 5740.0 * self.eosq + 3708.276 * eoc
            else:
                g211 = -72.099 + 331.819 * eq - 508.738 * self.eosq + 266.724 * eoc
                g310 = -346.844 + 1582.851 * eq - 2415.925 * self.eosq + 1246.113 * eoc
                g322 = -342.585 + 1554.908 * eq - 2366.899 * self.eosq + 1215.972 * eoc
                g410 = -1052.797 + 4758.686 * eq - 7193.992 * self.eosq + 3651.957 * eoc
                g422 = -3581.69 + 16178.11 * eq - 24462.77 * self.eosq + 12422.52 * eoc
                if eq <= 0.715:
                    g520 = 1464.74 - 4664.75 * eq + 3763.64 * self.eosq
                else:
                    g520 = -5149.66 + 29936.92 * eq - 54087.36 * self.eosq + 31324.56 * eoc
            if eq < 0.7:
                g533 = -919.2277 + 4988.61 * eq - 9064.77 * self.eosq + 5542.21 * eoc
                g521 = -822.71072 + 4568.6173 * eq - 8491.4146 * self.eosq + 5337.524 * eoc
                g532 = -853.666 + 4690.25 * eq - 8624.77 * self.eosq + 5341.4 * eoc
            else:
                g533 = -37995.78 + 161616.52 * eq - 229838.2 * self.eosq + 109377.94 * eoc
                g521 = -51752.104 + 218913.95 * eq - 309468.16 * self.eosq + 146349.42 * eoc
                g532 = -40023.88 + 170470.89 * eq - 242699.48 * self.eosq + 115605.82 * eoc

            sini2 = self.sinio * self.sinio
            f220 = 0.75 * (1.0 + 2.0 * self.cosio + self.theta2)
            f221 = 1.5 * sini2
            f321 = 1.875 * self.sinio * (1.0 - 2.0 * self.cosio - 3.0 * self.theta2)
            f322 = -1.875 * self.sinio * (1.0 + 2.0 * self.cosio - 3.0 * self.theta2)
            f441 = 35.0 * sini2 * f220
            f442 = 39.3750 * sini2 * sini2
            f522 = 9.84375 * self.sinio * (
                sini2 * (1.0 - 2.0 * self.cosio - 5.0 * self.theta2)
                + 0.33333333 * (-2.0 + 4.0 * self.cosio + 6.0 * self.theta2)
            )
            f523 = self.sinio * (
                4.92187512 * sini2 * (-2.0 - 4.0 * self.cosio + 10.0 * self.theta2)
                + 6.56250012 * (1.0 + 2.0 * self.cosio - 3.0 * self.theta2)
            )
            f542 = 29.53125 * self.sinio * (
                2.0 - 8.0 * self.cosio
                + self.theta2 * (-12.0 + 8.0 * self.cosio + 10.0 * self.theta2)
            )
            f543 = 29.53125 * self.sinio * (
                -2.0 - 8.0 * self.cosio
                + self.theta2 * (12.0 + 8.0 * self.cosio - 10.0 * self.theta2)
            )
            xno2 = self.xnq * self.xnq
            ainv2 = aqnv * aqnv
            temp1 = 3.0 * xno2 * ainv2
            temp = temp1 * c.root22
            self.d2201 = temp * f220 * g201
            self.d2211 = temp * f221 * g211
            temp1 *= aqnv
            temp = temp1 * c.root32
            self.d3210 = temp * f321 * g310
            self.d3222 = temp * f322 * g322
            temp1 *= aqnv
            temp = 2.0 * temp1 * c.root44
            self.d4410 = temp * f441 * g410
            self.d4422 = temp * f442 * g422
            temp1 *= aqnv
            temp = temp1 * c.root52
            self.d5220 = temp * f522 * g520
            self.d5232 = temp * f523 * g532
            temp = 2.0 * temp1 * c.root54
            self.d5421 = temp * f542 * g521
            self.d5433 = temp * f543 * g533
            self.xlamo = xmao + 2.0 * tle.xnodeo - 2.0 * self.thgr
            bfact = self.xmdot + 2.0 * self.xnodot - 2.0 * c.thdt
            bfact += self.ssl + 2.0 * self.ssh

        if self.resonance:
            self.xfact = bfact - self.xnq
            self.xli = self.xlamo
            self.xni = self.xnq
            self.atime = 0.0
        self.stepp, self.stepn, self.step2 = 720.0, -720.0, 259200.0
        # periodic caches
        self.pe = self.pinc = self.pl = 0.0
        self.sghs = self.shs = self.sghl = self.sh1 = 0.0

    # ------------------------------------------------------------------
    # Deep(dpsec)
    def _deep_secular(self, t, xll, omgadf, xnode):
        xll += self.ssl * t
        omgadf += self.ssg * t
        xnode += self.ssh * t
        em = self.tle.eo + self.sse * t
        xinc = self.tle.xincl + self.ssi * t
        if xinc < 0.0:
            xinc = -xinc
            xnode += c.pi
            omgadf -= c.pi
        xn = self.xnodp
        if not self.resonance:
            return xll, omgadf, xnode, em, xinc, xn

        delt = 0.0
        ft = 0.0
        xndot = xnddt = xldot = 0.0
        epoch_restart = False
        while True:
            if (
                self.atime == 0.0
                or (t >= 0.0 and self.atime < 0.0)
                or (t < 0.0 and self.atime >= 0.0)
            ):
                delt = self.stepp if t >= 0.0 else self.stepn
                self.atime = 0.0
                self.xni = self.xnq
                self.xli = self.xlamo
            elif abs(t) >= abs(self.atime):
                delt = self.stepp if t > 0.0 else self.stepn

            while True:
                if abs(t - self.atime) >= self.stepp:
                    do_loop = True
                    epoch_restart = False
                else:
                    ft = t - self.atime
                    do_loop = False
                if abs(t) < abs(self.atime):
                    delt = self.stepn if t >= 0.0 else self.stepp
                    do_loop = True
                    epoch_restart = True

                if self.synchronous:
                    xndot = (
                        self.del1 * math.sin(self.xli - self.fasx2)
                        + self.del2 * math.sin(2.0 * (self.xli - self.fasx4))
                        + self.del3 * math.sin(3.0 * (self.xli - self.fasx6))
                    )
                    xnddt = (
                        self.del1 * math.cos(self.xli - self.fasx2)
                        + 2.0 * self.del2 * math.cos(2.0 * (self.xli - self.fasx4))
                        + 3.0 * self.del3 * math.cos(3.0 * (self.xli - self.fasx6))
                    )
                else:
                    xomi = self.omegaq + self.omgdot * self.atime
                    x2omi = xomi + xomi
                    x2li = self.xli + self.xli
                    xndot = (
                        self.d2201 * math.sin(x2omi + self.xli - c.g22)
                        + self.d2211 * math.sin(self.xli - c.g22)
                        + self.d3210 * math.sin(xomi + self.xli - c.g32)
                        + self.d3222 * math.sin(-xomi + self.xli - c.g32)
                        + self.d4410 * math.sin(x2omi + x2li - c.g44)
                        + self.d4422 * math.sin(x2li - c.g44)
                        + self.d5220 * math.sin(xomi + self.xli - c.g52)
                        + self.d5232 * math.sin(-xomi + self.xli - c.g52)
                        + self.d5421 * math.sin(xomi + x2li - c.g54)
                        + self.d5433 * math.sin(-xomi + x2li - c.g54)
                    )
                    xnddt = (
                        self.d2201 * math.cos(x2omi + self.xli - c.g22)
                        + self.d2211 * math.cos(self.xli - c.g22)
                        + self.d3210 * math.cos(xomi + self.xli - c.g32)
                        + self.d3222 * math.cos(-xomi + self.xli - c.g32)
                        + self.d5220 * math.cos(xomi + self.xli - c.g52)
                        + self.d5232 * math.cos(-xomi + self.xli - c.g52)
                        + 2.0 * (
                            self.d4410 * math.cos(x2omi + x2li - c.g44)
                            + self.d4422 * math.cos(x2li - c.g44)
                            + self.d5421 * math.cos(xomi + x2li - c.g54)
                            + self.d5433 * math.cos(-xomi + x2li - c.g54)
                        )
                    )
                xldot = self.xni + self.xfact
                xnddt *= xldot

                if do_loop:
                    self.xli += xldot * delt + xndot * self.step2
                    self.xni += xndot * delt + xnddt * self.step2
                    self.atime += delt
                if not (do_loop and not epoch_restart):
                    break
            if not (do_loop and epoch_restart):
                break

        xn = self.xni + xndot * ft + xnddt * ft * ft * 0.5
        xl = self.xli + xldot * ft + xndot * ft * ft * 0.5
        temp = -xnode + self.thgr + t * c.thdt
        xll = xl + temp + temp if not self.synchronous else xl - omgadf + temp
        return xll, omgadf, xnode, em, xinc, xn

    # ------------------------------------------------------------------
    # Deep(dpper)
    def _deep_periodic(self, t, em, xinc, omgadf, xnode, xll):
        sinis = math.sin(xinc)
        cosis = math.cos(xinc)
        if abs(self.savtsn - t) >= 30.0:
            self.savtsn = t
            zm = self.zmos + c.zns * t
            zf = zm + 2.0 * c.zes * math.sin(zm)
            sinzf = math.sin(zf)
            f2 = 0.5 * sinzf * sinzf - 0.25
            f3 = -0.5 * sinzf * math.cos(zf)
            ses = self.se2 * f2 + self.se3 * f3
            sis = self.si2 * f2 + self.si3 * f3
            sls = self.sl2 * f2 + self.sl3 * f3 + self.sl4 * sinzf
            self.sghs = self.sgh2 * f2 + self.sgh3 * f3 + self.sgh4 * sinzf
            self.shs = self.sh2 * f2 + self.sh3 * f3
            zm = self.zmol + c.znl * t
            zf = zm + 2.0 * c.zel * math.sin(zm)
            sinzf = math.sin(zf)
            f2 = 0.5 * sinzf * sinzf - 0.25
            f3 = -0.5 * sinzf * math.cos(zf)
            sel = self.ee2 * f2 + self.e3 * f3
            sil = self.xi2 * f2 + self.xi3 * f3
            sll = self.xl2 * f2 + self.xl3 * f3 + self.xl4 * sinzf
            self.sghl = self.xgh2 * f2 + self.xgh3 * f3 + self.xgh4 * sinzf
            self.sh1 = self.xh2 * f2 + self.xh3 * f3
            self.pe = ses + sel
            self.pinc = sis + sil
            self.pl = sls + sll

        pgh = self.sghs + self.sghl
        ph = self.shs + self.sh1
        xinc += self.pinc
        em += self.pe

        if self.xqncl >= 0.2:
            ph /= self.sinio
            pgh -= self.cosio * ph
            omgadf += pgh
            xnode += ph
            xll += self.pl
        else:
            # Lyddane modification
            sinok = math.sin(xnode)
            cosok = math.cos(xnode)
            alfdp = sinis * sinok
            betdp = sinis * cosok
            dalf = ph * cosok + self.pinc * cosis * sinok
            dbet = -ph * sinok + self.pinc * cosis * cosok
            alfdp += dalf
            betdp += dbet
            xnode = fmod2p(xnode)
            xls = xll + omgadf + cosis * xnode
            dls = self.pl + pgh - self.pinc * xnode * sinis
            xls += dls
            xnoh = xnode
            xnode = actan(alfdp, betdp)
            if abs(xnoh - xnode) > c.pi:
                xnode += c.twopi if xnode < xnoh else -c.twopi
            xll += self.pl
            omgadf = xls - xll - math.cos(xinc) * xnode
        return em, xinc, omgadf, xnode, xll

    # ------------------------------------------------------------------
    def propagate(self, tsince: float) -> SatState:
        tle = self.tle
        xmdf = tle.xmo + self.xmdot * tsince
        omgadf = tle.omegao + self.omgdot * tsince
        xnoddf = tle.xnodeo + self.xnodot * tsince
        tsq = tsince * tsince
        xnode = xnoddf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * tsince
        tempe = tle.bstar * self.c4 * tsince
        templ = self.t2cof * tsq

        xll, omgadf, xnode, em, xinc, xn = self._deep_secular(tsince, xmdf, omgadf, xnode)
        xmdf = xll
        a = (c.xke / xn) ** c.tothrd * tempa * tempa
        em -= tempe
        xmam = xmdf + self.xnodp * templ

        em, xinc, omgadf, xnode, xmam = self._deep_periodic(
            tsince, em, xinc, omgadf, xnode, xmam
        )
        xl = xmam + omgadf + xnode
        xn = c.xke / a**1.5

        # the C applies short-period corrections with the EPOCH cosio/sinio
        # (deep_arg.cosio/sinio set at init) but the CURRENT inclination base
        return _short_period(
            self, a, em, xl, xn, xnode, omgadf, self.cosio, self.sinio, xinc
        )
