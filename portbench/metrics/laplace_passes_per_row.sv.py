"""laplace_passes_per_row.sv: ``laplace_passes_per_row`` read in the SV
cell, where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("laplace_passes_per_row")
