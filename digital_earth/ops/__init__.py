"""Low-level vectorized ops: math, sampling, spectra, texture gathers."""
