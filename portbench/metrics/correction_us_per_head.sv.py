"""correction_us_per_head.sv: ``correction_us_per_head`` read in the SV cell,
where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("correction_us_per_head")
