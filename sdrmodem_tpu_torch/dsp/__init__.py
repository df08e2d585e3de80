"""DSP blocks of the demodulator: taps, config, elementwise ops, clock, pipeline."""
