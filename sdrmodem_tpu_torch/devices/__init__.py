"""SDR devices: file source, sdr-server client, PlutoSDR over libiio, and
the native read-ahead."""
