"""Traffic drivers, one a mix's ``driver``: set-up, the measured window
and the check of what the window produced."""
