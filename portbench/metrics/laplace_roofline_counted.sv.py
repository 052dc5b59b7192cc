"""laplace_roofline_counted.sv: ``laplace_roofline_counted`` read in the SV
cell, where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("laplace_roofline_counted")
