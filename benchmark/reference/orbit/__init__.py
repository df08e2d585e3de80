"""A frozen copy of the SGP4 propagator, its TLE parser, time helpers and
observer geometry (upstream src/sgpsdp/), for the reference's Doppler rows.
Near-earth orbits only: the benchmark's passes are LEO."""
