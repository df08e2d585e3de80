"""SGP4/SDP4 orbit propagation and observer geometry (pure Python, float64).

A copy of ``sdrmodem_tpu/orbit/`` with its imports pointing here: the
port may not import the JAX package, whose ``__init__`` switches JAX to
x64 for every importer.  It feeds the host half of Doppler correction
(``dsp/doppler.py``) at 1 Hz of stream time.
"""
