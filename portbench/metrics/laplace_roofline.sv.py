"""laplace_roofline.sv: ``laplace_roofline`` read in the SV cell,
where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("laplace_roofline")
