"""Observer geometry: ground-station ECI state and topocentric observation.

Behavioural equivalent of reference src/sgpsdp/sgp_obs.c (WGS72 oblate
geoid, Astronomical Almanac K11 formulation).  ``range_rate`` (km/s) is
the quantity that drives Doppler correction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import constants as c
from .timeutil import actan, fmod2p, theta_g_jd


@dataclass
class Geodetic:
    lat: float  # rad
    lon: float  # rad
    alt: float  # km


@dataclass
class ObsSet:
    az: float  # rad
    el: float  # rad
    range: float  # km
    range_rate: float  # km/s


def user_pos_vel(jul_utc: float, geo: Geodetic):
    """Observer ECI position (km) and velocity (km/s); Earth-fixed site."""
    theta = fmod2p(theta_g_jd(jul_utc) + geo.lon)  # LMST
    f = c.f
    sin_lat = math.sin(geo.lat)
    cc = 1.0 / math.sqrt(1.0 + f * (f - 2.0) * sin_lat * sin_lat)
    sq = (1.0 - f) ** 2 * cc
    achcp = (c.xkmper * cc + geo.alt) * math.cos(geo.lat)
    pos = (
        achcp * math.cos(theta),
        achcp * math.sin(theta),
        (c.xkmper * sq + geo.alt) * sin_lat,
    )
    vel = (-c.mfactor * pos[1], c.mfactor * pos[0], 0.0)
    return pos, vel, theta


def calculate_obs(jul_utc, sat_pos, sat_vel, geo: Geodetic) -> ObsSet:
    """Topocentric az/el/range/range-rate of a satellite ECI state."""
    obs_pos, obs_vel, theta = user_pos_vel(jul_utc, geo)
    rng = tuple(s - o for s, o in zip(sat_pos, obs_pos))
    rgvel = tuple(s - o for s, o in zip(sat_vel, obs_vel))
    rng_mag = math.sqrt(sum(v * v for v in rng))

    sin_lat, cos_lat = math.sin(geo.lat), math.cos(geo.lat)
    sin_theta, cos_theta = math.sin(theta), math.cos(theta)
    top_s = sin_lat * cos_theta * rng[0] + sin_lat * sin_theta * rng[1] - cos_lat * rng[2]
    top_e = -sin_theta * rng[0] + cos_theta * rng[1]
    top_z = cos_lat * cos_theta * rng[0] + cos_lat * sin_theta * rng[1] + sin_lat * rng[2]
    azim = math.atan(-top_e / top_s) if top_s != 0.0 else math.copysign(c.pio2, -top_e)
    if top_s > 0:
        azim += c.pi
    if azim < 0:
        azim += c.twopi
    el = math.asin(top_z / rng_mag)
    range_rate = sum(r * v for r, v in zip(rng, rgvel)) / rng_mag
    return ObsSet(az=azim, el=el, range=rng_mag, range_rate=range_rate)


def calculate_lat_lon_alt(jul_utc: float, pos) -> Geodetic:
    """ECI position -> geodetic lat/lon/alt (ground track); sgp_obs.c:46-72."""
    theta = actan(pos[1], pos[0])
    lon = fmod2p(theta - theta_g_jd(jul_utc))
    r = math.sqrt(pos[0] ** 2 + pos[1] ** 2)
    e2 = c.f * (2.0 - c.f)
    lat = actan(pos[2], r)
    while True:
        phi = lat
        cc = 1.0 / math.sqrt(1.0 - e2 * math.sin(phi) ** 2)
        lat = actan(pos[2] + c.xkmper * cc * e2 * math.sin(phi), r)
        if abs(lat - phi) < 1e-10:
            break
    alt = r / math.cos(lat) - c.xkmper * cc
    if lat > c.pio2:
        lat -= c.twopi
    return Geodetic(lat=lat, lon=lon, alt=alt)


def calculate_ra_dec(jul_utc: float, sat_pos, sat_vel, geo: Geodetic):
    """Topocentric right ascension / declination (radians) of a satellite
    (sgp_obs.c Calculate_RADec_and_Obs, Escobal pp. 401-402)."""
    obs = calculate_obs(jul_utc, sat_pos, sat_vel, geo)
    az, el = obs.az, obs.el
    phi = geo.lat
    theta = fmod2p(theta_g_jd(jul_utc) + geo.lon)
    sin_theta, cos_theta = math.sin(theta), math.cos(theta)
    sin_phi, cos_phi = math.sin(phi), math.cos(phi)
    lxh = -math.cos(az) * math.cos(el)
    lyh = math.sin(az) * math.cos(el)
    lzh = math.sin(el)
    sx, ex, zx = sin_phi * cos_theta, -sin_theta, cos_theta * cos_phi
    sy, ey, zy = sin_phi * sin_theta, cos_theta, sin_theta * cos_phi
    sz, ez, zz = -cos_phi, 0.0, sin_phi
    lx = sx * lxh + ex * lyh + zx * lzh
    ly = sy * lxh + ey * lyh + zy * lzh
    lz = sz * lxh + ez * lyh + zz * lzh
    dec = math.asin(lz)
    cos_delta = math.sqrt(1.0 - lz * lz)
    ra = fmod2p(actan(ly / cos_delta, lx / cos_delta))
    return ra, dec
