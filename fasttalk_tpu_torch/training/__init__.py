"""Training-side data of the port (the calibration corpus AWQ reads)."""
