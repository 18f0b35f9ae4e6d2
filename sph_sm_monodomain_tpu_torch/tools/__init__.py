"""Measurement tools of the port (mirror of the JAX repository's `tools/`):
`roofline` gives the sweeps' hardware-relative efficiency on the card."""
